"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points do not fall back to the CPU when no card is present."""
import pathlib
import re
import subprocess
import sys

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
    assert "polar_tpu_torch.ops.cuda_scl" in mods and len(mods) >= 20
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
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if _IMPORT.search(p.read_text())]
    assert offenders == []
    assert _IMPORT.search("from polar_tpu.ops import scl")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from polar_tpu_torch.ops import scl")
    assert not _IMPORT.search("# counterpart of polar_tpu/ops/scl.py")


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

