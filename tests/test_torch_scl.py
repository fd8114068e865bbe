"""The port's plain PyTorch SCL decoder against the JAX XLA decoder
`build_scl_decoder` on the CPU (not Pallas interpret mode, which is too
slow; the JAX suite already holds Pallas == XLA).

u, payload and crc_ok must be equal. pm is held to
allclose(rtol=1e-6, atol=1e-5): the JAX decoder's node metric sums
(R0/REP, polar_tpu/ops/scl.py) reduce in a backend-defined order, the port
in a fixed pairwise tree, so the float sums may differ in the last ulps.
"""
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.construction.ga import construct_ga
from polar_tpu.models import presets as j_presets
from polar_tpu.models.polar import CodeSpec as JCodeSpec
from polar_tpu.models.polar import CrcSpec as JCrcSpec
from polar_tpu.ops.scl import build_scl_decoder as j_build_scl_decoder
from polar_tpu_torch.models import polar as t_polar
from polar_tpu_torch.models import presets as t_presets
from polar_tpu_torch.models.polar import spec_from_reference
from polar_tpu_torch.ops import scl as t_scl
from polar_tpu_torch.ops.cuda_scl import SclDecoder, build_tables
from polar_tpu_torch.sim.golden import load_golden

ROOT = pathlib.Path(__file__).resolve().parents[1]
CRC8 = JCrcSpec(8, 0x07, 0)
CRC16 = JCrcSpec(16, 0x1021, 0)
BATCH = 64

# every N with every L; CRC-less, 8-bit and 16-bit CRCs spread across them
CASES = [
    (16, 1, None), (16, 2, CRC8), (16, 3, None), (16, 4, CRC8), (16, 8, None),
    (32, 1, CRC16), (32, 2, None), (32, 3, CRC8), (32, 4, CRC16), (32, 8, CRC8),
    (64, 1, CRC8), (64, 2, CRC16), (64, 3, None), (64, 4, CRC8), (64, 8, CRC16),
    (64, 32, CRC8),
]


@functools.lru_cache(maxsize=None)
def _jax_spec(N, crc):
    K = N // 2 - (crc.width if crc else 0) // 2
    nk = K + (crc.width if crc else 0)
    mask = tuple(int(v) for v in construct_ga(N, nk, 2.0))
    return JCodeSpec(N=N, K=K, factors=(2,) * int(np.log2(N)),
                     frozen_mask=mask, crc=crc)


@functools.lru_cache(maxsize=None)
def _jax_decoder(N, L, crc):
    return jax.jit(j_build_scl_decoder(_jax_spec(N, crc), L))


def _llrs(N, L, kind):
    rng = np.random.default_rng(N * 10 + L)
    x = 2.5 * rng.standard_normal((BATCH, N)) + 0.5
    if kind == "int":
        x = np.round(x)          # integer LLRs: metric and position ties
    return x.astype(np.float32)


def _assert_matches(out, ref):
    for f in ("u", "payload", "crc_ok"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    np.testing.assert_allclose(out.pm.numpy(), np.asarray(ref.pm),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["gauss", "int"])
@pytest.mark.parametrize("N,L,crc", CASES)
def test_plain_matches_jax(N, L, crc, kind):
    x = _llrs(N, L, kind)
    ref = _jax_decoder(N, L, crc)(jnp.asarray(x))
    spec = spec_from_reference(_jax_spec(N, crc))
    out = t_scl.build_plain_scl_decoder(spec, L)(torch.as_tensor(x))
    _assert_matches(out, ref)
    assert out.u.dtype == torch.int8 and out.payload.dtype == torch.int8
    assert out.crc_ok.dtype == torch.bool and out.pm.dtype == torch.float32
    assert out.payload.shape == (BATCH, spec.n_payload_slots)


def test_fork_tie_order_matches_top_k():
    """2P -> P fork on integer metrics full of ties: the same survivors in
    the same order as lax.top_k on the negated candidates."""
    rng = np.random.default_rng(0)
    for P in (2, 3, 4, 5, 8, 16, 32):
        pm = rng.integers(0, 4, (P, 128)).astype(np.float32)
        pen0 = rng.integers(0, 3, (P, 128)).astype(np.float32)
        pen1 = rng.integers(0, 3, (P, 128)).astype(np.float32)
        cand = np.concatenate([pm + pen0, pm + pen1], axis=0)
        vals, idx = jax.lax.top_k(-jnp.asarray(cand).T, P)
        c = np.asarray(idx).T
        npm, perm, bit = t_scl.fork2(*(torch.as_tensor(a) for a in (pm, pen0, pen1)))
        assert np.array_equal(npm.numpy(), -np.asarray(vals).T)
        assert np.array_equal(perm.numpy(), c % P)
        assert np.array_equal(bit.numpy(), c // P)


def test_extract_mins_ties_lowest_index():
    x = torch.tensor([[3., 1., 1., 0., 0., 2., 1., 0.]]).reshape(1, 8, 1)
    vals, poss = t_scl.extract_mins(x, 6)
    assert [int(p) for p in poss] == [3, 4, 7, 1, 2, 6]
    assert [float(v) for v in vals] == [0., 0., 0., 1., 1., 1.]


def test_tree_sum_fixed_pairwise_order():
    x = torch.tensor([1e8, 1., -1e8, 1.], dtype=torch.float32).reshape(1, 4, 1)
    # (1e8 + -1e8) + (1 + 1) = 2, whereas a left-to-right sum gives 1
    assert float(t_scl.tree_sum(x)) == 2.0


def test_golden_replay_full_width():
    """results/golden_ca_scl_b256.npz: 256 flagship frames (N=1024 K=512
    + CRC-16, L=8; 43 erroneous) from the independent C++ decoder."""
    spec, L, llrs, u_ref = load_golden(ROOT / "results" / "golden_ca_scl_b256.npz")
    assert spec == t_presets.ca_scl().spec and L == 8
    dec = t_scl.build_scl_decoder(spec, L, device="cpu")
    out = dec(llrs)
    assert int((out.u.numpy() != u_ref).any(axis=1).sum()) == 0
    assert out.u.shape == (256, 1024)


@pytest.mark.parametrize("name", sorted(j_presets.PRESETS))
def test_spec_from_reference_presets(name):
    jspec = j_presets.get_preset(name).spec
    tspec = spec_from_reference(jspec)
    assert tspec == t_presets.get_preset(name).spec
    assert np.array_equal(tspec.info_positions, jspec.info_positions)
    assert tspec.block_sizes == jspec.block_sizes
    if jspec.crc is not None:
        assert np.array_equal(tspec.crc.generator_matrix(jspec.K),
                              jspec.crc.generator_matrix(jspec.K))


def test_cpu_decoder_entry_points():
    jspec = _jax_spec(32, CRC8)
    spec = spec_from_reference(jspec)
    x = _llrs(32, 4, "gauss")
    ref = _jax_decoder(32, 4, CRC8)(jnp.asarray(x))
    dec = t_scl.build_scl_decoder(spec, 4, device="cpu")
    assert isinstance(dec, SclDecoder)
    _assert_matches(dec(x), ref)                      # numpy in, moved to cpu
    _assert_matches(dec.kernel(torch.as_tensor(x)), ref)   # cpu -> plain version
    sc = t_scl.build_sc_decoder(spec, device="cpu")
    _assert_matches(sc(x), _jax_decoder(32, 1, CRC8)(jnp.asarray(x)))


def test_unported_options_raise():
    spec = spec_from_reference(_jax_spec(16, None))
    for kw in ({"genie": True}, {"fast": False}, {"unroll": False},
               {"f_mode": "exact"}, {"pm_mode": "smooth"},
               {"llr_dtype": torch.bfloat16}, {"fast_r1_scl": False}):
        with pytest.raises(NotImplementedError):
            t_scl.build_scl_decoder(spec, 2, device="cpu", **kw)
    with pytest.raises(ValueError):
        t_scl.build_scl_decoder(spec, 33, device="cpu")
    with pytest.raises(ValueError):
        t_scl.build_scl_decoder(spec, 2, device="cpu", big_stage_backend="mosaic")
    with pytest.raises(ValueError):
        t_scl.build_scl_decoder(spec, 2, device="cpu", subtree_backend="mosaic")
    with pytest.raises(NotImplementedError, match="kernel sizes"):
        t_scl.build_scl_decoder(
            t_polar.CodeSpec(N=3, K=1, factors=(3,), frozen_mask=(1, 1, 0)), 1,
            device="cpu")
    dec = t_scl.build_scl_decoder(spec, 2, device="cpu")
    with pytest.raises(ValueError):
        dec(np.zeros((4, 8), np.float32))


def test_kernel_tables_for_ca_scl():
    """The CUDA kernel's host tables: op program, span rows, payload rows
    and CRC masks agree with the spec (the kernel itself runs on the card:
    tests/test_torch_cuda.py)."""
    spec = t_presets.ca_scl().spec
    t = build_tables(spec, 8)
    kinds = np.bincount(t["ops"][:, 0], minlength=9)
    assert t["ops"].shape == (316, 4)
    assert list(kinds) == [79, 79, 78, 13, 25, 17, 25, 0, 0]
    assert t["Q"] == 80 and t["W"] == 16 and t["K"] == 512
    assert np.all(np.diff(t["qrow"]) >= 0) and t["qrow"][-1] == 79
    assert np.array_equal(np.nonzero(t["pidx"] >= 0)[0], spec.info_positions)
    # CRC as XOR of generator-row masks == the spec's CRC
    rng = np.random.default_rng(2)
    info = rng.integers(0, 2, spec.K)
    acc = np.bitwise_xor.reduce(t["gmask"].view(np.uint32)[info == 1]) ^ t["offmask"]
    crc_bits = spec.crc.compute(info)            # MSB first, bit w <-> column w
    assert int(acc) == int(sum(int(b) << w for w, b in enumerate(crc_bits)))
