"""The port's C++ golden codec (polar_tpu_torch/native.py, built from
polar_tpu_torch/csrc/polar_ref.cpp into build/), its recorder and replay
(polar_tpu_torch/sim/golden.py), and the committed records of
polar_tpu_torch/records/, on the CPU:

- the port's NativeGolden equals the JAX package's (encode and decode) on
  tests/test_native_golden.py's specs, and the port's oracle;
- `record_golden` writes the JAX recorder's fields and values on the same
  inputs, and `replay_check(device="cpu")` finds 0 mismatches;
- each committed record is reproducible from its `RECORDS` entry (spec,
  LLRs, the first frames' decisions; the whole record under `slow`) and
  replays with 0 mismatching frames through the plain version of each of
  its routes (the two records of results/ replay on the CPU in
  test_torch_scl.py and test_torch_subtree.py, through `replay_check` on
  the card in test_torch_cuda.py).
"""
import pathlib

import numpy as np
import pytest
import torch

from polar_tpu.models.polar import CrcSpec as JCrcSpec
from polar_tpu.native import NativeGolden as JNativeGolden
from polar_tpu.sim import golden as j_golden
from polar_tpu_torch import native as t_native
from polar_tpu_torch import oracle as t_oracle
from polar_tpu_torch.models.polar import spec_from_reference
from polar_tpu_torch.models.presets import bch_sc
from polar_tpu_torch.ops import cuda_build
from polar_tpu_torch.sim import golden as t_golden
from polar_tpu_torch.utils.gf2 import gf2_matmul
from tests.test_native_golden import _spec as _native_spec
from tests.test_pallas_scl import _mixed_spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
NATIVE_SPECS = [((2, 2, 2, 2), 8, 1, None), ((2, 2, 2, 2), 8, 4, None),
                ((16,), 8, 2, None),
                ((2, 2, 2, 2, 2), 10, 4, JCrcSpec(width=8, poly=0x07))]
ROUTES = [(name, label, kw) for name, rec in t_golden.RECORDS.items()
          for label, kw, _ in rec.routes]
# frames re-recorded in tier-1: a bch_sc frame costs the C++ codec 4-6
# CPU-seconds (brute-force 16x16 tails), a capacity-32 frame at most 1.3
RERECORD_FRAMES = {"golden_bch_sc_l1": 2, "golden_bch_sc_l8": 2}


def test_host_codec_builds_into_build_dir():
    lib = cuda_build.build_host(t_native.SOURCE)
    assert lib.parent == ROOT / "build" and lib.exists()
    assert lib == cuda_build.host_library_path(t_native.SOURCE)
    assert (ROOT / "polar_tpu_torch" / "csrc" / "polar_ref.cpp").read_bytes() \
        == (ROOT / "native" / "polar_ref.cpp").read_bytes()
    assert t_native.SOURCE not in cuda_build.SOURCES


def test_host_build_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        cuda_build.build_host(t_native.SOURCE)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("factors", [(2, 2, 2), (16,), (16, 2), (2, 16, 2)])
def test_native_encode_matches_jax(factors):
    jspec = _native_spec(factors, int(np.prod(factors)) // 2)
    spec = spec_from_reference(jspec)
    u = np.random.default_rng(0).integers(0, 2, (6, spec.N)).astype(np.uint8)
    x = t_native.NativeGolden(spec).encode(u)
    assert np.array_equal(x, JNativeGolden(jspec).encode(u))
    assert np.array_equal(x, gf2_matmul(u, spec.generator))


@pytest.mark.parametrize("factors,K,L,crc", NATIVE_SPECS)
def test_native_decode_matches_jax_and_oracle(factors, K, L, crc):
    jspec = _native_spec(factors, K, crc)
    spec = spec_from_reference(jspec)
    llrs = np.random.default_rng(5).normal(0.5, 2.0, (12, spec.N))
    got = t_native.NativeGolden(spec).decode(llrs, L)
    assert np.array_equal(got, JNativeGolden(jspec).decode(llrs, L))
    for i in range(llrs.shape[0]):
        ref = (t_oracle.scl_decode(spec, llrs[i], L) if L > 1
               else t_oracle.sc_decode(spec, llrs[i]))
        assert np.array_equal(got[i], ref), i


def test_record_golden_matches_jax(tmp_path):
    jspec = _native_spec((2, 2, 2, 2, 2), 12, JCrcSpec(width=8, poly=0x07))
    spec = spec_from_reference(jspec)
    llrs = np.random.default_rng(9).normal(0.7, 1.6, (24, spec.N))
    t_u = t_golden.record_golden(spec, 4, llrs, tmp_path / "port.npz")
    j_u = j_golden.record_golden(jspec, 4, llrs, tmp_path / "jax.npz")
    assert np.array_equal(t_u, j_u)
    t_z, j_z = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(t_z.files) == sorted(j_z.files)
    for f in j_z.files:
        assert t_z[f].dtype == j_z[f].dtype, f
        assert np.array_equal(t_z[f], j_z[f]), f
    # the LLRs were rounded to float32 before the decode
    assert np.array_equal(t_z["llrs"], llrs.astype(np.float32).astype(np.float64))
    spec2, L2, _, u_ref = t_golden.load_golden(tmp_path / "port.npz")
    assert spec2 == spec and L2 == 4 and np.array_equal(u_ref, t_u)
    res = t_golden.replay_check(tmp_path / "port.npz", device="cpu")
    assert res == {"frames": 24, "mismatch_frames": 0, "mismatch_bits": 0}


def test_replay_check_counts_mismatches(tmp_path):
    """A record whose decisions are flipped in two frames (three bits)
    reports them."""
    spec = spec_from_reference(_native_spec((2, 2, 2, 2), 8))
    llrs = np.random.default_rng(3).normal(0.5, 2.0, (10, spec.N))
    path = tmp_path / "rec.npz"
    u_ref = t_golden.record_golden(spec, 4, llrs, path)
    z = dict(np.load(path))
    z["u_ref"] = u_ref.copy()
    z["u_ref"][2, 0] ^= 1
    z["u_ref"][7, [1, 5]] ^= 1
    np.savez(path, **z)
    assert t_golden.replay_check(path, device="cpu") == {
        "frames": 10, "mismatch_frames": 2, "mismatch_bits": 3}


def test_replay_check_raises_without_card_and_on_unknown_arguments():
    path = t_golden.record_path("golden_c32_arikan")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_golden.replay_check(path)
    with pytest.raises(TypeError):
        t_golden.replay_check(path, device="cpu", backend="pallas")
    with pytest.raises(ValueError):
        t_golden.replay_check(path, device="cpu", subtree_backend="triton")


def test_record_specs():
    """The records' specs: the bch_sc preset, phase 17's (2,)*7 spec and
    tests/test_torch_subtree.py's (2, 16, 2) spec (the JAX suite's
    `_mixed_spec` recipe), with their list sizes and frame counts."""
    crc8 = JCrcSpec(width=8, poly=0x07)
    want = {"golden_bch_sc_l1": (bch_sc().spec, 1, 128),
            "golden_bch_sc_l8": (bch_sc().spec, 8, 64),
            "golden_c32_arikan": (spec_from_reference(
                _mixed_spec((2,) * 7, 56, crc8)), 32, 256),
            "golden_c32_subtree": (spec_from_reference(
                _mixed_spec((2, 16, 2), 14, crc8)), 32, 128)}
    assert set(t_golden.RECORDS) == set(want)
    for name, rec in t_golden.RECORDS.items():
        spec, L, frames = want[name]
        assert (rec.spec(), rec.list_size, rec.frames) == (spec, L, frames)
        assert rec.ebn0_db[0] < rec.ebn0_db[1]


@pytest.mark.parametrize("name", sorted(t_golden.RECORDS))
def test_committed_record_is_reproducible(name):
    """The committed file holds its entry's spec and list size, and the
    LLRs its seed draws (rounded to float32); re-recording its first
    frames (8, bch_sc 2) with the port's codec gives the committed
    decisions."""
    rec = t_golden.RECORDS[name]
    spec, L, llrs, u_ref = t_golden.load_golden(t_golden.record_path(name))
    assert spec == rec.spec() and L == rec.list_size
    assert llrs.shape == u_ref.shape == (rec.frames, spec.N)
    want = t_golden.record_llrs(spec, rec).astype(np.float32).astype(np.float64)
    assert np.array_equal(llrs, want)
    n = RERECORD_FRAMES.get(name, 8)
    u = t_native.NativeGolden(spec).decode(llrs[:n], L)
    assert np.array_equal(u, u_ref[:n])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(t_golden.RECORDS))
def test_committed_record_rerecords_whole(name, tmp_path):
    """The whole record re-recorded (bch_sc L=1 ~75 s on 8 CPUs)."""
    rec = t_golden.RECORDS[name]
    spec, L, llrs, u_ref = t_golden.load_golden(t_golden.record_path(name))
    assert np.array_equal(
        t_golden.record_golden(spec, L, llrs, tmp_path / "again.npz"), u_ref)


@pytest.mark.parametrize("name,route,kw", ROUTES,
                         ids=[f"{n}-{r}" for n, r, _ in ROUTES])
def test_committed_record_replays_on_cpu(name, route, kw):
    rec = t_golden.RECORDS[name]
    res = t_golden.replay_check(t_golden.record_path(name), device="cpu", **kw)
    assert res == {"frames": rec.frames, "mismatch_frames": 0,
                   "mismatch_bits": 0}


def test_cli_records_if_absent_then_replays(monkeypatch, tmp_path, capsys):
    """`python -m polar_tpu_torch.sim.golden --record NAME` writes the
    record where it is missing and replays it through each route;
    `--replay PATH` replays any record."""
    monkeypatch.setattr(t_golden, "RECORDS_DIR", tmp_path)
    small = t_golden.Record(
        lambda: t_golden.jittered_spec((2, 16), 8, t_golden.CRC8), 4, 8,
        (1.0, 3.0), 7, (("default", {}, "scl_decode"),
                        ("hybrid", {"big_stage_backend": "pallas"},
                         "stage_down")))
    monkeypatch.setitem(t_golden.RECORDS, "golden_small", small)
    assert t_golden.main(["--record", "golden_small", "--device", "cpu"]) == 0
    assert (tmp_path / "golden_small.npz").exists()
    out = capsys.readouterr().out
    assert "recorded 8 frames" in out and out.count('"mismatch_frames": 0') == 2
    assert t_golden.main(["--replay", str(tmp_path / "golden_small.npz"),
                          "--device", "cpu", "--big-stage", "pallas"]) == 0
    assert "recorded" not in capsys.readouterr().out
