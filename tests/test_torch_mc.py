"""The port's fused Monte-Carlo step (ops/mc.py, ops/philox.py) on the CPU,
held against the JAX package's XLA ops.

The TPU kernel's PRNG cannot be reproduced (and the JAX interpreter's is
constant, tests/test_pallas_mc.py), so these tests pin the port's own
Philox stream by known answers and compare the decomposition of the step
with JAX: the CRC, the encode, the channel expression and the decode on
the same frames and the same injected noise. u, fe and be must be equal;
pm is held to allclose(rtol=1e-6, atol=1e-5) as in tests/test_torch_scl.py
(the JAX decoder's node sums reduce in a backend-defined order). The
kernels themselves run on the card: tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.construction.ga import construct_ga
from polar_tpu.models.polar import CodeSpec as JCodeSpec
from polar_tpu.models.polar import CrcSpec as JCrcSpec
from polar_tpu.ops.crc import crc_check as j_crc_check
from polar_tpu.ops.encode import encode_u as j_encode_u
from polar_tpu.ops.scl import build_scl_decoder as j_build_scl_decoder
from polar_tpu_torch.models.polar import spec_from_reference
from polar_tpu_torch.ops import philox
from polar_tpu_torch.ops.mc import (build_mc_step, count_errors, mc_channel,
                                    mc_draw, mc_frames)
from polar_tpu_torch.ops.scl import build_plain_scl_decoder

CRC16 = JCrcSpec(16, 0x1021, 0)
B = 128


@functools.lru_cache(maxsize=None)
def _jspec(N, K, crc):
    mask = tuple(int(v) for v in construct_ga(N, K + (crc.width if crc else 0), 2.0))
    return JCodeSpec(N=N, K=K, factors=(2,) * int(np.log2(N)),
                     frozen_mask=mask, crc=crc)


def _spec(N=64, K=24, crc=CRC16):
    return spec_from_reference(_jspec(N, K, crc))


# ---- Philox4x32-10 ----

@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, expect):
    """Random123's known-answer vectors, in both implementations."""
    assert philox.philox4x32_10_int(ctr, key) == expect
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    out = philox.philox4x32_10(*c, *key)
    assert tuple(int(o) for o in out) == expect


def test_philox_torch_matches_int_reference():
    rng = np.random.default_rng(1)
    edge = [0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    ctrs = np.concatenate([rng.integers(0, 2**32, (200, 4), dtype=np.int64),
                           np.array([[e] * 4 for e in edge], np.int64),
                           rng.choice(edge, (50, 4)).astype(np.int64)])
    for key in [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0x12345678, 0x9ABCDEF0)]:
        out = philox.philox4x32_10(*(torch.as_tensor(ctrs[:, i]) for i in range(4)),
                                   *key)
        got = torch.stack(out, dim=1).numpy()
        ref = np.array([philox.philox4x32_10_int(c, key) for c in ctrs])
        assert np.array_equal(got, ref)
        assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


def test_random_words_layout():
    """word w of row b = output (w mod 4) of counter (w div 4, b, 0, 0)."""
    w = philox.random_words((7, 9), 3, 16)
    assert w.shape == (3, 16) and w.dtype == torch.int64
    for b in range(3):
        for j in range(4):
            assert tuple(w[b, 4 * j:4 * j + 4].tolist()) == \
                philox.philox4x32_10_int((j, b, 0, 0), (7, 9))


def test_step_seed_deterministic_and_distinct():
    grid = [(i, s, u) for i in range(10) for s in range(250) for u in range(4)]
    seeds = [philox.step_seed(123456789012, *g) for g in grid]
    assert len(grid) == 10_000 and len(set(seeds)) == len(grid)
    assert seeds[17] == philox.step_seed(123456789012, *grid[17])
    assert philox.step_seed(0, 0, 0, 0) == philox.philox4x32_10_int((0, 0, 0, 0), (0, 0))[:2]
    assert philox.step_seed(1, 0, 0, 0) != philox.step_seed(1 << 32, 0, 0, 0)
    assert all(0 <= v <= 0xFFFFFFFF for s in seeds[:100] for v in s)


# ---- mc_draw: frames, CRC, encode, channel ----

def test_mc_frames_frozen_crc_encode():
    jspec = _jspec(64, 24, CRC16)
    spec = _spec()
    u_true, x, _ = mc_frames(spec, (5, 6), B)
    u = u_true.numpy()
    assert u.dtype == np.int8 and u.shape == (B, 64)
    assert (u[:, spec.frozen.astype(bool)] == 0).all()
    payload = u[:, spec.info_positions]
    assert np.asarray(j_crc_check(CRC16, jnp.asarray(payload))).all()
    assert 0.4 < payload[:, :spec.K].mean() < 0.6
    assert np.array_equal(x.numpy(), np.asarray(j_encode_u(jspec, jnp.asarray(u))))


def test_mc_gauss_matches_numpy_box_muller():
    N, batch = 64, 2048                       # 2^17 words, 2^16 normals
    spec = _spec(N)
    _, _, g = mc_frames(spec, (11, 12), batch)
    w = philox.random_words((11, 12), batch, 2 * N).numpy()
    f32 = np.float32
    u1 = ((w[:, N:N + N // 2] >> 8).astype(f32) + f32(1)) * f32(2.0 ** -24)
    u2 = (w[:, N + N // 2:] >> 8).astype(f32) * f32(2.0 ** -24)
    r = np.sqrt(f32(-2) * np.log(u1))
    th = f32(2 * np.pi) * u2
    ref = np.concatenate([r * np.cos(th), r * np.sin(th)], axis=1)
    assert ref.dtype == np.float32 and g.dtype == torch.float32
    # torch and numpy take their float32 log/sin/cos from different
    # libraries (a few ulp apart); atol covers the zeros of sin and cos,
    # where a relative error is unbounded
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert abs(float(g.mean())) < 0.02 and abs(float(g.var()) - 1.0) < 0.02


def test_mc_channel_expression_matches_jax():
    """llr = (2 / (sigma sigma)) * ((1 - 2x) + sigma * gauss), the kernel's
    order, bit for bit against the same float32 expression in JAX."""
    spec = _spec()
    _, x, g = mc_frames(spec, (1, 2), B)
    for sigma in (0.5, 0.9, 1.3):
        sg = jnp.float32(sigma)
        ref = (2.0 / (sg * sg)) * ((1.0 - 2.0 * jnp.asarray(x.numpy()).astype(jnp.float32))
                                   + sg * jnp.asarray(g.numpy()))
        assert np.array_equal(mc_channel(x, g, sigma).numpy(), np.asarray(ref))


# ---- the step ----

def _noise(N, seed=11):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((B, N)),
                           dtype=torch.float32)


@pytest.mark.parametrize("L", [1, 4])
def test_step_matches_jax_with_injected_noise(L):
    """Mirrors tests/test_pallas_mc.py test_fused_counters_real_noise with
    the port's plain step: same frames, same noise, JAX XLA decoder."""
    jspec, spec = _jspec(64, 24, CRC16), _spec()
    sigma = 0.9
    noise = _noise(64)
    full = build_mc_step(spec, L, device="cpu")
    fe, be, u_true, res = full((3, 2), sigma, B, noise)
    assert int(fe) > 0, "sigma=0.9 must produce frame errors"
    sg = jnp.float32(sigma)
    x = j_encode_u(jspec, jnp.asarray(u_true.numpy())).astype(jnp.float32)
    llr = (2.0 / (sg * sg)) * ((1.0 - 2.0 * x) + sg * jnp.asarray(noise.numpy()))
    out = jax.jit(j_build_scl_decoder(jspec, L))(llr)
    assert np.array_equal(res.u.numpy(), np.asarray(out.u))
    assert np.array_equal(res.crc_ok.numpy(), np.asarray(out.crc_ok))
    np.testing.assert_allclose(res.pm.numpy(), np.asarray(out.pm),
                               rtol=1e-6, atol=1e-5)
    mask = np.zeros(64, bool)
    mask[spec.info_positions[:spec.K]] = True
    diff = (np.asarray(out.u) != u_true.numpy()) & mask[None, :]
    assert int(diff.any(axis=1).sum()) == int(fe)
    assert int(diff.sum()) == int(be)
    cnt = build_mc_step(spec, L, device="cpu", counters=True)
    fe_c, be_c, u_c, res_c = cnt((3, 2), sigma, B, noise)
    assert (int(fe_c), int(be_c), u_c, res_c) == (int(fe), int(be), None, None)


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("sigma", [0.05, 0.9])
def test_counters_mode_matches_full(L, sigma):
    spec = _spec()
    full = build_mc_step(spec, L, device="cpu")
    cnt = build_mc_step(spec, L, device="cpu", counters=True)
    fe_f, be_f, u_true, res = full((7, 1), sigma, B)
    fe_c, be_c, _, _ = cnt((7, 1), sigma, B)
    assert (int(fe_f), int(be_f)) == (int(fe_c), int(be_c))
    per = cnt.counts((7, 1), sigma, B)
    assert per.shape == (2, B) and per.dtype == torch.int32
    assert torch.equal(per, count_errors(spec, res.u, u_true))
    assert int(per[0].sum()) == int(fe_c) and int(per[1].sum()) == int(be_c)


@pytest.mark.parametrize("crc,L", [(None, 1), (CRC16, 4)])
def test_noiseless_round_trip(crc, L):
    """Mirrors tests/test_pallas_mc.py test_fused_mc_structure."""
    spec = _spec(64, 24, crc)
    fe, be, u_true, res = build_mc_step(spec, L, device="cpu")((9, 3), 0.05, B)
    assert int(fe) == 0 and int(be) == 0
    assert torch.equal(res.u, u_true)
    assert bool(res.crc_ok.all())


@pytest.mark.parametrize("L", [1, 3, 8])
def test_trajectory_epilogue_equals_plain_decode(L):
    spec = _spec()
    step = build_mc_step(spec, L, device="cpu")
    traj_bit, traj_perm, pm, u_true = step.trajectory((4, 4), 0.8, B)
    assert traj_bit.shape == (64, L, B) and traj_bit.dtype == torch.int8
    assert traj_perm.shape == (len(step.decoder.spans), L, B)
    assert traj_perm.dtype == torch.int64 and pm.shape == (L, B)
    u2, llr = mc_draw(spec, (4, 4), 0.8, B)
    assert torch.equal(u2, u_true)
    ref = build_plain_scl_decoder(spec, L)(llr)
    got = step.decoder.epilogue(traj_bit, traj_perm, pm)
    for f in ref._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_step_checks_noise_and_seed():
    spec = _spec()
    step = build_mc_step(spec, 2, device="cpu")
    noise = _noise(64)
    _, _, u_own, res_own = step((1, 2), 0.8, B)
    _, _, u_in, res_in = step((1, 2), 0.8, B, noise)
    assert torch.equal(u_in, u_own)           # noise replaces the gaussians only
    assert torch.equal(res_in.u, step.decoder.plain(mc_draw(spec, (1, 2), 0.8, B,
                                                            noise=noise)[1]).u)
    assert not torch.equal(res_in.pm, res_own.pm)
    for bad in (torch.zeros((B, 32)), noise.double(), noise.T.contiguous().T):
        with pytest.raises(ValueError):
            step((1, 2), 0.8, B, bad)
    with pytest.raises(ValueError):
        step((1 << 32, 2), 0.8, B)
