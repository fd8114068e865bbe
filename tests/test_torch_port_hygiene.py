"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points do not fall back to the CPU when no card is present."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "polar_tpu_torch"
_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|polar_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|polar_tpu)\b(?!_torch)[\w.]*\s+import\b)", re.M)


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_import_leaves_no_jax_or_polar_tpu():
    mods = _modules()
    assert {"polar_tpu_torch.ops.cuda_scl", "polar_tpu_torch.parallel.mesh",
            "polar_tpu_torch.entry", "polar_tpu_torch.oracle",
            "polar_tpu_torch.native"} <= set(mods) and len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'polar_tpu' or m.startswith('polar_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_or_polar_tpu():
    sources = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if _IMPORT.search(p.read_text())]
    assert offenders == []
    assert _IMPORT.search("from polar_tpu.ops import scl")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from polar_tpu_torch.ops import scl")
    assert not _IMPORT.search("# counterpart of polar_tpu/ops/scl.py")


def test_native_codec_never_touches_native_dir(monkeypatch):
    """The port's golden codec builds from polar_tpu_torch/csrc/ into
    build/ and loads from there: it opens, runs and loads nothing under
    native/ (the JAX package's codec and its library)."""
    import ctypes
    import importlib
    import os

    from polar_tpu_torch.models.presets import bch_sc
    from polar_tpu_torch.ops import cuda_build

    native_dir = ROOT / "native"
    lib = native_dir / "libpolar_ref.so"
    before = (lib.stat().st_mtime_ns, sorted(p.name for p in native_dir.iterdir()))
    touched = []
    real_run, real_cdll, real_open = subprocess.run, ctypes.CDLL, open

    def watch(*paths):
        touched.extend(str(p) for p in paths if "native" in str(p).split(os.sep))

    def run(cmd, *a, **k):
        watch(*cmd)
        return real_run(cmd, *a, **k)

    def cdll(path, *a, **k):
        watch(path)
        return real_cdll(path, *a, **k)

    def opener(path, *a, **k):
        watch(path)
        return real_open(path, *a, **k)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr("builtins.open", opener)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", ROOT / "build" / "hygiene_host")
    from polar_tpu_torch import native
    native = importlib.reload(native)
    spec = bch_sc().spec
    g = native.NativeGolden(spec)
    assert g.encode(np.zeros((1, spec.N), np.uint8)).sum() == 0
    assert touched == []
    loaded = cuda_build.host_library_path(native.SOURCE)
    assert loaded.parent == ROOT / "build" / "hygiene_host" and loaded.exists()
    # nor does its source name that directory as a path
    assert not re.search(r"""["'/]native["'/]""",
                         (PKG / "native.py").read_text().replace(
                             "native/polar_ref.cpp", ""))
    after = (lib.stat().st_mtime_ns, sorted(p.name for p in native_dir.iterdir()))
    assert after == before


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from polar_tpu_torch.models.presets import ca_scl
    from polar_tpu_torch.ops.scl import build_sc_decoder, build_scl_decoder
    from polar_tpu_torch.utils.device import resolve_device

    spec = ca_scl().spec
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_scl_decoder(spec, 8)
    with pytest.raises(RuntimeError):
        build_sc_decoder(spec)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_sweep_entry_points_raise_without_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from polar_tpu_torch import entry
    from polar_tpu_torch.models.presets import ca_scl, sweep
    from polar_tpu_torch.ops.mc import build_mc_step
    from polar_tpu_torch.parallel import mesh
    from polar_tpu_torch.sim import sweep_cli
    from polar_tpu_torch.sim.harness import make_mc_step, run_sweep

    spec = ca_scl().spec
    for mode in ({}, {"counters": True}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_mc_step(spec, 8, **mode)
    for backend in ("torch", "fused"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mc_step(spec, 8, backend=backend)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_sweep(sweep(), frames=1, backend=backend, progress=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_cli.main(["--preset", "sweep", "--backend", "fused",
                        "--frames", "1"])
    # the multi-device entry points: no card, no process group, no gloo
    # in place of NCCL
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_batch_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "29500"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.init_multihost(backend=backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_cli.main(["--preset", "sweep", "--backend", "fused",
                        "--frames", "1", "--dist-backend", "nccl"])
    with pytest.raises(ValueError, match="NCCL"):
        mesh.init_multihost(device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()


def test_every_smoke_kernel_counts_its_launches():
    """chip_smoke.py's kernel table names only kernels whose wrappers count
    launches, and every kernel of the library is in it."""
    import chip_smoke
    from polar_tpu_torch.models.presets import bch_sc
    from polar_tpu_torch.ops import cuda_build, cuda_scl, cuda_stage

    assert set(chip_smoke.KERNELS) == \
        set(cuda_scl.LAUNCHES) | set(cuda_stage.LAUNCHES)
    assert set(cuda_scl.LAUNCHES) == set(cuda_scl.KERNELS)
    sources = {name: ROOT / src for name, (src, _) in chip_smoke.KERNELS.items()}
    assert all(sources[name] == cuda_scl.SOURCE for name in cuda_scl.KERNELS)
    assert sources["stage_down"] == cuda_stage.SOURCE
    assert {p.name for p in sources.values()} == set(cuda_build.SOURCES)
    for name, (_, replaces) in chip_smoke.KERNELS.items():
        path, line = replaces.split(":")
        assert "pallas_call" in (ROOT / path).read_text().splitlines()[int(line) - 1]
    # the stage kernel's launches in one bch_sc hybrid decode
    assert len(chip_smoke.stage_launch_set(bch_sc().spec, 1)) == 105

