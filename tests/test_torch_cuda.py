"""The CUDA kernels (scl_decode, scl_decode_traj, scl_mc_traj,
scl_mc_counters, and stage_down) against their plain PyTorch versions, on
the card, for Arikan, eBCH and mixed-kernel codes; and the sweep's fetch,
trace and multi-card step on the card.

Run on a machine with an NVIDIA Hopper card (--noconftest: the suite's
conftest imports JAX, which the port's machine need not have):
    pytest --noconftest -m gpu tests/test_torch_cuda.py
Here, without a card, every test skips (decided in the fixture).
The kernels and the plain versions sum in the same fixed order and draw
the same Philox words, so every output, pm included, must be equal bit
for bit.
"""
import ctypes
import pathlib

import numpy as np
import pytest
import torch

from polar_tpu_torch.construction.ga import construct_ga
from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.models.presets import ca_scl
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.ops.scl import build_scl_decoder
from polar_tpu_torch.sim.golden import load_golden

ROOT = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: pytest --noconftest -m gpu tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _spec(N, K, crc):
    mask = tuple(int(v) for v in construct_ga(N, K + (crc.width if crc else 0), 2.0))
    return CodeSpec(N=N, K=K, factors=(2,) * int(np.log2(N)), frozen_mask=mask,
                    crc=crc)


def _equal(a, b):
    for f in ("u", "payload", "crc_ok", "pm"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("N,K,crc", [(16, 4, CrcSpec(8, 0x07, 0)),
                                     (64, 28, CrcSpec(8, 0x07, 0)),
                                     (128, 56, CrcSpec(16, 0x1021, 0)),
                                     (256, 128, None)])
def test_kernel_matches_plain(cuda, N, K, crc, L, quant):
    dec = build_scl_decoder(_spec(N, K, crc), L, device=cuda)
    rng = np.random.default_rng(N + L)
    x = 3.0 * rng.standard_normal((512, N))
    if quant:
        x = np.round(x)
    x = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    _equal(dec.kernel(x), dec.plain(x))


def test_golden_replay_through_kernel(cuda):
    spec, L, llrs, u_ref = load_golden(ROOT / "results" / "golden_ca_scl_b256.npz")
    before = cuda_scl.LAUNCHES["scl_decode"]
    out = build_scl_decoder(spec, L, device=cuda)(llrs)
    assert cuda_scl.LAUNCHES["scl_decode"] == before + 1
    assert int((out.u.cpu().numpy() != u_ref).any(axis=1).sum()) == 0


def test_ca_scl_kernel_matches_plain(cuda):
    dec = build_scl_decoder(ca_scl().spec, 8, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = 2.0 + 1.5 * torch.randn((1024, 1024), generator=gen, device=cuda)
    _equal(dec.kernel(x), dec.plain(x))


def test_wrapper_rejects_bad_input(cuda):
    dec = build_scl_decoder(_spec(16, 4, None), 2, device=cuda)
    with pytest.raises(TypeError):
        dec.kernel(torch.zeros((4, 16), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        dec.kernel(torch.zeros((4, 8), device=cuda))
    with pytest.raises(ValueError):
        dec.kernel(torch.zeros((16, 4), device=cuda).T)


# ---- K2 (scl_decode_traj), K4 (scl_mc_traj), K5 (scl_mc_counters) ----

_SMALL = [(64, 28, CrcSpec(8, 0x07, 0)), (128, 56, CrcSpec(16, 0x1021, 0)),
          (256, 128, None)]


def _same(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("L", [1, 3, 4, 8])
@pytest.mark.parametrize("N,K,crc", _SMALL)
def test_trajectory_kernel_matches_plain(cuda, N, K, crc, L):
    dec = cuda_scl.SclDecoder(_spec(N, K, crc), L, cuda, select=False)
    rng = np.random.default_rng(N * L)
    for v in (3.0 * rng.standard_normal((512, N)),
              np.round(3.0 * rng.standard_normal((512, N)))):
        x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        before = cuda_scl.LAUNCHES["scl_decode_traj"]
        traj = dec.trajectory(x)
        assert cuda_scl.LAUNCHES["scl_decode_traj"] == before + 1
        _same(traj, dec.plain_trajectory(x))
        _equal(dec.epilogue(*traj), dec.plain(x))
        _equal(dec.kernel(x), dec.plain(x))


@pytest.mark.parametrize("L", [1, 4, 8])
@pytest.mark.parametrize("N,K,crc", _SMALL)
def test_mc_kernels_match_plain_with_noise(cuda, N, K, crc, L):
    from polar_tpu_torch.ops.mc import build_mc_step
    spec = _spec(N, K, crc)
    full = build_mc_step(spec, L, device=cuda)
    rng = np.random.default_rng(N + L)
    noise = torch.as_tensor(rng.standard_normal((512, N)), dtype=torch.float32,
                            device=cuda)
    for sigma in (0.6, 0.9):
        seed = (int(rng.integers(2**32)), int(rng.integers(2**32)))
        _same(full.trajectory(seed, sigma, 512, noise),
              full.plain_trajectory(seed, sigma, 512, noise))
        cnt = full.counts(seed, sigma, 512, noise)
        assert torch.equal(cnt, full.plain_counts(seed, sigma, 512, noise))
        fe, be, _, _ = full(seed, sigma, 512, noise)
        assert int(fe) == int(cnt[0].sum()) and int(be) == int(cnt[1].sum())


@pytest.mark.parametrize("L", [1, 4, 8])
def test_mc_kernels_in_kernel_philox(cuda, L):
    """u_true bit for bit; decisions and counts equal on all frames (both
    sides use the CUDA math library's logf/sinf/cosf)."""
    from polar_tpu_torch.ops.mc import build_mc_step, count_errors
    spec = _spec(128, 56, CrcSpec(16, 0x1021, 0))
    full = build_mc_step(spec, L, device=cuda)
    cnt_step = build_mc_step(spec, L, device=cuda, counters=True)
    for sigma in (0.6, 0.9):
        seed = (2026, 11)
        k = full.trajectory(seed, sigma, 1024)
        p = full.plain_trajectory(seed, sigma, 1024)
        assert torch.equal(k[3], p[3])
        _same(k, p)
        cnt = cnt_step.counts(seed, sigma, 1024)
        assert torch.equal(cnt, cnt_step.plain_counts(seed, sigma, 1024))
        res = full.decoder.epilogue(*k[:3])
        assert torch.equal(count_errors(spec, res.u, k[3]), cnt)


def test_sweep_backends_agree_on_card(cuda):
    from polar_tpu_torch.models.presets import Preset
    from polar_tpu_torch.sim.harness import run_sweep
    spec = _spec(64, 16, CrcSpec(8, 0x07, 0))
    preset = Preset("tiny", spec, 4, (1.0, 3.0), 4096, 512)
    recs = [run_sweep(preset, device=cuda, backend=b, progress=False)
            for b in ("torch", "fused")]
    for a, b in zip(*recs):
        assert a["frame_errors"] == b["frame_errors"] > 0
        assert a["bit_errors"] == b["bit_errors"]


def test_launch_on_a_card_that_is_not_current(cuda):
    """Each kernel launches on its tensors' card, whichever is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from polar_tpu_torch.ops.mc import build_mc_step
    other = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    spec = _spec(64, 28, CrcSpec(8, 0x07, 0))
    x = torch.as_tensor(3.0 * np.random.default_rng(5).standard_normal((256, 64)),
                        dtype=torch.float32, device=other)
    for select in (True, False):
        dec = cuda_scl.SclDecoder(spec, 4, other, select=select)
        _equal(dec.kernel(x), dec.plain(x))
    step = build_mc_step(spec, 4, device=other)
    _same(step.trajectory((3, 4), 0.8, 256), step.plain_trajectory((3, 4), 0.8, 256))
    assert torch.equal(step.counts((3, 4), 0.8, 256),
                       step.plain_counts((3, 4), 0.8, 256))
    # the l > 2 instances and the stage kernel
    from polar_tpu_torch.kernels.bch import build_bch_kernel
    from polar_tpu_torch.ops import cuda_stage
    big = _mixed((16, 2), 12, None)
    xb = torch.as_tensor(2.0 * np.random.default_rng(6).standard_normal((256, 32)),
                         dtype=torch.float32, device=other)
    for select in (True, False):
        dec = cuda_scl.SclDecoder(big, 2, other, select=select)
        _equal(dec.kernel(xb), dec.plain(xb))
    fn = cuda_stage.build_down_kernel(build_bch_kernel(16), 7, 2, 4)
    lam = torch.randn((2, 16, 4, 300), device=other)
    assert torch.equal(fn(lam), fn.plain(lam))
    torch.cuda.synchronize(other)


def test_mc_step_rejects_bad_noise(cuda):
    from polar_tpu_torch.ops.mc import build_mc_step
    step = build_mc_step(_spec(16, 4, None), 2, device=cuda)
    with pytest.raises(ValueError):
        step((1, 2), 0.8, 4, torch.zeros((4, 16), device=cuda).T.contiguous().T)
    with pytest.raises(ValueError):
        step((1, 2), 0.8, 4, torch.zeros((4, 8), device=cuda))
    with pytest.raises(ValueError):
        step((1, 2), 0.8, 4, torch.zeros((4, 16), dtype=torch.float64, device=cuda))


# ---- l > 2 kernels: the stage kernel (K6) and the body's l > 2 branch ----

def _mixed(factors, K, crc, seed=1):
    N = int(np.prod(factors))
    r = np.random.default_rng(seed)
    nk = K + (crc.width if crc else 0)
    mask = np.ones(N, np.uint8)
    mask[np.argsort(r.random(N) + np.linspace(0, 1, N))[-nk:]] = 0
    return CodeSpec(N=N, K=K, factors=tuple(factors),
                    frozen_mask=tuple(int(v) for v in mask), crc=crc)


_MIXED = [((16,), 6, None), ((4, 4), 6, None), ((8, 2, 4), 30, CrcSpec(8, 0x07, 0)),
          ((16, 2), 12, None), ((2, 16), 10, CrcSpec(8, 0x07, 0)),
          ((16, 2, 2), 20, CrcSpec(8, 0x07, 0))]


@pytest.mark.parametrize("l", [4, 8, 16])
def test_stage_kernel_matches_plain(cuda, l):
    from polar_tpu_torch.kernels.bch import build_bch_kernel
    from polar_tpu_torch.ops import cuda_stage
    K = build_bch_kernel(l)
    gen = torch.Generator(device=cuda).manual_seed(l)
    for paths, n, B in ((1, 16, 512), (3, 1, 1000), (8, 4, 64)):
        lam = 2.0 * torch.randn((paths, l, n, B), generator=gen, device=cuda)
        for quant in (False, True):
            x = torch.round(lam) if quant else lam
            for i in range(l - 1):
                fn = cuda_stage.build_down_kernel(K, i, paths, n)
                before = cuda_stage.LAUNCHES["stage_down"]
                got = fn(x)
                assert cuda_stage.LAUNCHES["stage_down"] == before + 1
                assert torch.equal(got, fn.plain(x)), (l, i, paths, n, quant)


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 7, 8])
@pytest.mark.parametrize("factors,K,crc", _MIXED)
def test_big_stage_body_matches_plain(cuda, factors, K, crc, L):
    spec = _mixed(factors, K, crc)
    rng = np.random.default_rng(spec.N + L)
    x = torch.as_tensor(2.0 * rng.standard_normal((256, spec.N)) + 0.5,
                        dtype=torch.float32, device=cuda)
    for select in (True, False):
        dec = cuda_scl.SclDecoder(spec, L, cuda, select=select)
        _equal(dec.kernel(x), dec.plain(x))
        if not select:
            _same(dec.trajectory(x), dec.plain_trajectory(x))


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 7, 8])
@pytest.mark.parametrize("factors,K,crc", _MIXED)
def test_big_stage_mc_kernels_match_plain(cuda, factors, K, crc, L):
    from polar_tpu_torch.ops.mc import build_mc_step
    spec = _mixed(factors, K, crc)
    step = build_mc_step(spec, L, device=cuda)
    rng = np.random.default_rng(spec.N * L)
    noise = torch.as_tensor(rng.standard_normal((256, spec.N)), dtype=torch.float32,
                            device=cuda)
    seed = (int(rng.integers(2**32)), int(rng.integers(2**32)))
    _same(step.trajectory(seed, 0.8, 256, noise),
          step.plain_trajectory(seed, 0.8, 256, noise))
    assert torch.equal(step.counts(seed, 0.8, 256, noise),
                       step.plain_counts(seed, 0.8, 256, noise))
    # the in-kernel Philox draw: the same transmitted u
    assert torch.equal(step.trajectory(seed, 0.8, 256)[3],
                       step.plain_trajectory(seed, 0.8, 256)[3])


@pytest.mark.parametrize("L", [4, 5, 6, 7, 8])
def test_golden_mixed_spec_kernels_match_plain(cuda, L):
    """The golden mixed spec (N=512, (16,2,2,2,2,2)) takes the two-warp
    instances (K1, K2 and K3 from L=6; K4, K5 from L=7): K1, K2, K4, K5
    and K3 (the whole spec, path-bound) == plain, on Gaussian inputs and
    (K1, K2) integer ones."""
    from polar_tpu_torch.ops.mc import build_mc_step
    spec = load_golden(ROOT / "results" / "golden_mixed_scl_b128.npz")[0]
    k = cuda_scl.SclKernels(spec, L)
    for name in cuda_scl.KERNELS:
        want = 64 if L >= (7 if name in ("scl_mc_traj", "scl_mc_counters") else 6) else 32
        assert k.block_threads(name, cuda) == want, name
    rng = np.random.default_rng(500 + L)
    g = 2.0 * rng.standard_normal((256, spec.N)) + 0.5
    for v in (g, np.round(g)):
        x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        for select in (True, False):
            dec = cuda_scl.SclDecoder(spec, L, cuda, select=select)
            _equal(dec.kernel(x), dec.plain(x))
            if not select:
                _same(dec.trajectory(x), dec.plain_trajectory(x))
    step = build_mc_step(spec, L, device=cuda)
    noise = torch.as_tensor(rng.standard_normal((256, spec.N)), dtype=torch.float32,
                            device=cuda)
    seed = (int(rng.integers(2**32)), int(rng.integers(2**32)))
    _same(step.trajectory(seed, 0.8, 256, noise),
          step.plain_trajectory(seed, 0.8, 256, noise))
    assert torch.equal(step.counts(seed, 0.8, 256, noise),
                       step.plain_counts(seed, 0.8, 256, noise))
    core = cuda_scl.SubtreeKernel(spec, L)
    lam = torch.as_tensor(2.5 * rng.standard_normal((L, spec.N, 256)),
                          dtype=torch.float32, device=cuda)
    pm = torch.as_tensor(3.0 * rng.random((L, 256)), dtype=torch.float32, device=cuda)
    before = cuda_scl.LAUNCHES["scl_subtree"]
    _same(core(lam, pm), core.plain(lam, pm))
    assert cuda_scl.LAUNCHES["scl_subtree"] == before + 1


def test_bch_sc_kernels_and_hybrid(cuda):
    """bch_sc (N=256, 16x16 eBCH): K2 (L=1) and K1 (L=8) == plain, and
    the hybrid decoder (one K6 launch per trellis/table DOWN op, 105 a
    decode) == the kernel decode."""
    from polar_tpu_torch.models.presets import bch_sc
    from polar_tpu_torch.ops import cuda_stage
    spec = bch_sc().spec
    rng = np.random.default_rng(256)
    x = torch.as_tensor(2.0 * rng.standard_normal((1024, 256)) + 1.0,
                        dtype=torch.float32, device=cuda)
    sc = build_scl_decoder(spec, 1, device=cuda)
    _equal(sc.kernel(x), sc.plain(x))
    scl8 = build_scl_decoder(spec, 8, device=cuda)
    _equal(scl8.kernel(x), scl8.plain(x))
    hybrid = build_scl_decoder(spec, 1, device=cuda, big_stage_backend="pallas")
    before = cuda_stage.LAUNCHES["stage_down"]
    _equal(hybrid(x), sc(x))
    assert cuda_stage.LAUNCHES["stage_down"] == before + 105


@pytest.mark.parametrize("L", range(1, 9))
def test_bch_sc_kernels_on_tied_and_huge_llrs(cuda, L):
    """bch_sc's K1, K2 (integer LLRs: tied metrics and positions; LLRs at
    +-1e30 and 4e30) and K4, K5 (integer noise, noise at 1e32) == plain.
    No +-inf: an l > 2 marginal of an infinite input is inf - inf, NaN,
    which the kernels' fmaxf and the plain version's maximum treat apart
    (the Arikan specs take one +-inf a codeword, test_arikan8_*)."""
    from polar_tpu_torch.models.presets import bch_sc
    from polar_tpu_torch.ops.mc import build_mc_step
    spec = bch_sc().spec
    rng = np.random.default_rng(40 + L)
    g = 3.0 * rng.standard_normal((1024, spec.N))
    for v in (np.round(g), _huge(g, rng, False)):
        x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        for select in (True, False):
            dec = cuda_scl.SclDecoder(spec, L, cuda, select=select)
            _equal(dec.kernel(x), dec.plain(x))
            if not select:
                _same(dec.trajectory(x), dec.plain_trajectory(x))
    step = build_mc_step(spec, L, device=cuda)
    n = rng.standard_normal((1024, spec.N))
    for v in (np.round(1.5 * n), np.where(rng.random(n.shape) < 0.3, 1e32, n)):
        noise = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        _same(step.trajectory((3, 4), 1.0, 1024, noise),
              step.plain_trajectory((3, 4), 1.0, 1024, noise))
        assert torch.equal(step.counts((3, 4), 1.0, 1024, noise),
                           step.plain_counts((3, 4), 1.0, 1024, noise))


def _bch_sc_pairs(cuda):
    """bch_sc's decoder and step at L = 1 (K2, K4, K5 two codewords a
    warp), after checking that the library runs them so."""
    from polar_tpu_torch.models.presets import bch_sc
    from polar_tpu_torch.ops.mc import build_mc_step
    from polar_tpu_torch.sim.kernel_times import instance_name
    spec = bch_sc().spec
    k = cuda_scl.SclKernels(spec, 1)
    for name in cuda_scl.KERNELS:
        two = name in cuda_scl.CW2_KERNELS
        assert cuda_scl.general_codewords(spec, 1, name) == (2 if two else 1)
        assert k.block_codewords(name, cuda) == (2 if two else 1), name
        assert k.block_threads(name, cuda) == 32
        assert (instance_name(spec, 1, name) == f"{name}_big_t32_cw2") == two
    return (spec, cuda_scl.SclDecoder(spec, 1, cuda, select=False),
            build_mc_step(spec, 1, device=cuda))


def _nan_equal(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x.is_floating_point():
            assert _same_nan(y, x), i
        else:
            assert torch.equal(x, y), i


@pytest.mark.parametrize("B", [8192, 1023])
def test_bch_sc_two_codewords_a_warp_match_plain(cuda, B):
    """bch_sc at L = 1: K2, K4 and K5 decode two codewords a warp, a
    half-warp each, and equal the plain version bit for bit (u, counters,
    pm) on channel LLRs at 0 dB, integer LLRs (tied positions) and LLRs at
    +-1e30 and 4e30, at an even batch and an odd one (the last block's
    second half idle, writing nothing); K4 and K5 on noise of the same
    kinds and on the in-kernel Philox draw."""
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    spec, dec, step = _bch_sc_pairs(cuda)
    rng = np.random.default_rng(B)
    sigma = float(ebn0_to_sigma(0.0, spec.rate))
    g = rng.standard_normal((B, spec.N))
    zero_db = (2.0 / sigma ** 2) * (1.0 + sigma * g)      # the all-zero codeword
    for v in (zero_db, np.round(3.0 * g), _huge(3.0 * g, rng, False)):
        x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        _equal(dec.kernel(x), dec.plain(x))
        _same(dec.trajectory(x), dec.plain_trajectory(x))
    seed = (int(rng.integers(2**32)), int(rng.integers(2**32)))
    for v in (g, np.round(1.5 * g), np.where(rng.random(g.shape) < 0.3, 1e32, g)):
        noise = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        _same(step.trajectory(seed, sigma, B, noise),
              step.plain_trajectory(seed, sigma, B, noise))
        assert torch.equal(step.counts(seed, sigma, B, noise),
                           step.plain_counts(seed, sigma, B, noise))
    _same(step.trajectory(seed, sigma, B), step.plain_trajectory(seed, sigma, B))
    assert torch.equal(step.counts(seed, sigma, B), step.plain_counts(seed, sigma, B))


def _k5_chunks_match(cuda, spec, L, batches, seed_base):
    """K5 at each batch, as the plan's chunks, as one device launch
    (`scl_launch` once over the whole grid) and in chunks of one round
    (the codewords every SM holds at once by the plan), on the in-kernel
    Philox draw and on given noise: the counters of all three equal the
    plain version's bit for bit, in both rows, and `CHUNKS` grows by the
    partition's launches. Returns (plan, round)."""
    from polar_tpu_torch.ops.mc import build_mc_step
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    step = build_mc_step(spec, L, device=cuda, counters=True)
    kern = step.decoder.kernels
    plan = kern.plan("scl_mc_counters", cuda)
    sms = cuda_scl.device_limits(cuda_scl._device_index(cuda)).sms
    rnd = plan.blocks_per_sm * sms * plan.codewords
    sigma = float(np.float32(ebn0_to_sigma(1.0, spec.rate)))
    rng = np.random.default_rng(seed_base)
    for B in batches:
        seed = (int(rng.integers(2**32)), int(rng.integers(2**32)))
        g = torch.as_tensor(rng.standard_normal((B, spec.N)), dtype=torch.float32,
                            device=cuda)
        for noise in (None, g):
            ref = step.plain_counts(seed, sigma, B, noise)
            for chunk in (None, B, rnd):
                parts = cuda_scl.launch_chunks(B, plan.chunk if chunk is None else chunk)
                cnt = torch.full((2, B), -1, dtype=torch.int32, device=cuda)
                before = cuda_scl.CHUNKS["scl_mc_counters"]
                kern.launch("scl_mc_counters", B, cuda, chunk=chunk, noise=noise,
                            seed0=seed[0], seed1=seed[1], sigma=sigma, counters=cnt)
                assert cuda_scl.CHUNKS["scl_mc_counters"] - before == len(parts)
                assert torch.equal(cnt, ref), (B, chunk, noise is None)
    return plan, rnd


def test_bch_sc_k5_in_chunks_equals_one_launch(cuda):
    """bch_sc's K5 (`_big_t32_cw2`, two codewords a block) in chunks equals
    one launch and the plain version at a batch of 1, a round - 1 and + 1
    (odd: the last block's second half decodes the last codeword again),
    two chunks + 1 and the cell's 32,768 (8 chunks of a round on an
    H100): a codeword draws the same Philox words and noise row whatever
    chunk it falls in."""
    from polar_tpu_torch.models.presets import bch_sc
    spec = bch_sc().spec
    plan = cuda_scl.SclKernels(spec, 1).plan("scl_mc_counters", cuda)
    sms = cuda_scl.device_limits(cuda_scl._device_index(cuda)).sms
    rnd = plan.blocks_per_sm * sms * plan.codewords
    assert (plan.instance, plan.codewords) == ("scl_mc_counters_big_t32_cw2", 2)
    assert plan.chunk == cuda_scl.K5_CHUNK_ROUNDS * rnd
    _k5_chunks_match(cuda, spec, 1, (1, rnd - 1, rnd + 1, 2 * plan.chunk + 1, 32768), 24)
    assert len(cuda_scl.launch_chunks(32768, plan.chunk)) == -(-32768 // plan.chunk)


def test_ca_scl_k5_in_chunks_equals_one_launch(cuda):
    """ca_scl's K5 (the Arikan body's `_t128`, one codeword a block) keeps
    one launch in its plan; in chunks of a round (`b0` in the Arikan body)
    it equals one launch and the plain version at the cell's 8,192 and at
    a round + 1. The library refuses a chunk past the first of any other
    kernel, which reads no `b0`."""
    spec = ca_scl().spec
    plan = cuda_scl.SclKernels(spec, 8).plan("scl_mc_counters", cuda)
    assert (plan.instance, plan.chunk) == ("scl_mc_counters_t128", 0)
    sms = cuda_scl.device_limits(cuda_scl._device_index(cuda)).sms
    _k5_chunks_match(cuda, spec, 8, (8192, plan.blocks_per_sm * sms + 1), 25)
    dec = cuda_scl.SclDecoder(spec, 8, cuda)
    x = torch.zeros((64, spec.N), device=cuda)
    out = {"u": torch.empty((64, spec.N), dtype=torch.int8, device=cuda),
           "pm": torch.empty(64, device=cuda), "ok": torch.empty(64, dtype=torch.bool, device=cuda)}
    with pytest.raises(RuntimeError, match="scl_decode launch failed"):
        dec.kernels.launch("scl_decode", 64, cuda, chunk=32, llr=x, **out)


def test_bch_sc_two_codewords_a_warp_never_mix(cuda):
    """A codeword with a +-inf LLR (its l > 2 marginals NaN) shares a warp
    with a finite one, in either half: the finite codewords still equal the
    plain version, and each infinite codeword decodes alike beside any
    neighbour (K2 on LLRs; K4, K5 on noise)."""
    spec, dec, step = _bch_sc_pairs(cuda)
    rng = np.random.default_rng(77)
    B = 1024
    g = 3.0 * rng.standard_normal((2, B, spec.N))
    rows = np.arange(B)
    for first in (0, 1):                  # the infinite codewords' half
        inf = rows % 2 == first
        v = g.copy()
        cols = rng.integers(0, spec.N, (2, B))
        v[0, inf, cols[0, inf]] = np.inf * np.sign(g[0, inf, cols[0, inf]])
        v[1, inf] = v[0, inf]              # same infinite rows, other neighbours
        got = []
        for side in v:
            x = torch.as_tensor(side, dtype=torch.float32, device=cuda)
            fin = torch.as_tensor(~inf, device=cuda)
            out, ref = dec.kernel(x), dec.plain(x)
            for f in ("u", "payload", "crc_ok", "pm"):
                assert torch.equal(getattr(out, f)[fin], getattr(ref, f)[fin]), f
            tb, tp, pm = dec.trajectory(x)
            rb, rp, rpm = dec.plain_trajectory(x)
            assert torch.equal(tb[..., fin], rb[..., fin])
            assert torch.equal(pm[..., fin], rpm[..., fin])
            noise = torch.as_tensor(side, dtype=torch.float32, device=cuda)
            counts = step.counts((5, 6), 0.8, B, noise)
            assert torch.equal(counts[..., fin],
                               step.plain_counts((5, 6), 0.8, B, noise)[..., fin])
            traj = step.trajectory((5, 6), 0.8, B, noise)
            got.append((out.u[~fin], out.pm[~fin], tb[..., ~fin], pm[..., ~fin],
                        counts[..., ~fin], traj[0][..., ~fin], traj[2][..., ~fin]))
        _nan_equal(got[0], got[1])


def test_bch_sc_sweep_routes_agree_on_card(cuda):
    from polar_tpu_torch.models.presets import Preset, bch_sc
    from polar_tpu_torch.sim.harness import run_sweep
    preset = Preset("bch_sc", bch_sc().spec, 1, (1.5, 2.5), 2048, 512)
    runs = [run_sweep(preset, device=cuda, progress=False, **kw)
            for kw in ({"backend": "torch"}, {"backend": "fused"},
                       {"backend": "torch", "big_stage_backend": "pallas"})]
    for recs in runs[1:]:
        for a, b in zip(runs[0], recs):
            assert a["frame_errors"] == b["frame_errors"] > 0
            assert a["bit_errors"] == b["bit_errors"]


# ---- list capacity 32 and the subtree kernel (K3) ----

_SUBTREE = [((2, 2, 2, 2, 2), 12, None), ((2, 16, 2), 14, CrcSpec(8, 0x07, 0)),
            ((16, 2, 2, 2), 40, CrcSpec(8, 0x07, 0))]


def _huge(x: np.ndarray, rng, inf: bool) -> np.ndarray:
    """x with ~30% of its entries at +-1e30 (the selection's kBig), 5% at
    +-4e30 and, if `inf` (Arikan specs: an f step never pairs two), one
    +-inf a row; l > 2 marginals of an infinite input give inf - inf."""
    pick = rng.random(x.shape)
    x = np.where(pick < 0.3, np.sign(x) * 1e30, x)
    x = np.where((pick > 0.3) & (pick < 0.35), np.sign(x) * 4e30, x)
    if inf:
        rows = x.reshape(-1, x.shape[-1])
        rows[np.arange(rows.shape[0]), rng.integers(0, x.shape[-1], rows.shape[0])] = (
            np.inf * np.sign(rng.standard_normal(rows.shape[0])))
    return x


@pytest.mark.parametrize("L", [1, 4, 9, 16, 31, 32])
@pytest.mark.parametrize("factors,K,crc", _SUBTREE)
def test_subtree_kernel_matches_plain(cuda, factors, K, crc, L):
    """Every depth-1 child of more than one op, on a path-bound input
    (a different row and metric a path): Gaussian inputs and unsorted
    metrics; integer inputs and metrics (tied candidates, tied
    least-reliable inputs); inputs at +-1e30 and above on sorted metrics
    (which K3 still forks by the general rank: pm_in is path-bound)."""
    from polar_tpu_torch.ops.program import build_program, subtree_items, subtree_spec
    spec = _mixed(factors, K, crc)
    subs = [it for it in subtree_items(build_program(spec, scl=L > 1), spec)
            if it[0] == "sub"]
    assert subs
    gen = torch.Generator(device=cuda).manual_seed(L)
    rng = np.random.default_rng(L)
    for _, _, fr in subs:
        core = cuda_scl.SubtreeKernel(subtree_spec(spec, fr), L)
        lam = 2.5 * torch.randn((L, core.spec.N, 256), generator=gen, device=cuda)
        pm = 3.0 * torch.rand((L, 256), generator=gen, device=cuda)
        before = cuda_scl.LAUNCHES["scl_subtree"]
        got = core(lam, pm)
        assert cuda_scl.LAUNCHES["scl_subtree"] == before + 1
        _same(got, core.plain(lam, pm))
        tied = torch.round(lam), torch.round(pm)
        huge = (torch.as_tensor(_huge(lam.cpu().numpy(), rng, False), device=cuda),
                pm.sort(dim=0).values)
        for x, m in (tied, huge):
            _same(core(x, m), core.plain(x, m))


@pytest.mark.parametrize("L", [4, 32])
@pytest.mark.parametrize("factors,K,crc", _SUBTREE)
def test_subtree_route_matches_kernel_decode(cuda, factors, K, crc, L):
    """build_scl_decoder(subtree_backend="pallas") with either stage route
    == the decode kernel (K1), one K3 launch a child."""
    from polar_tpu_torch.ops.program import build_program, subtree_items
    spec = _mixed(factors, K, crc)
    n_subs = sum(it[0] == "sub" for it in subtree_items(build_program(spec, scl=True),
                                                         spec))
    x = torch.as_tensor(2.0 * np.random.default_rng(L).standard_normal((256, spec.N)),
                        dtype=torch.float32, device=cuda)
    ref = build_scl_decoder(spec, L, device=cuda)(x)
    for big in ("xla", "pallas"):
        dec = build_scl_decoder(spec, L, device=cuda, subtree_backend="pallas",
                                big_stage_backend=big)
        before = cuda_scl.LAUNCHES["scl_subtree"]
        _equal(dec(x), ref)
        assert cuda_scl.LAUNCHES["scl_subtree"] == before + n_subs


@pytest.mark.parametrize("L", [9, 16, 31, 32])
@pytest.mark.parametrize("factors,K,crc", [((2,) * 6, 20, CrcSpec(8, 0x07, 0)),
                                           ((16, 2, 2), 20, CrcSpec(8, 0x07, 0)),
                                           ((2, 16, 2), 14, None)])
def test_capacity32_kernels_match_plain(cuda, factors, K, crc, L):
    """K1, K2 (Gaussian, integer: tied metrics and positions, and huge
    LLRs at +-1e30, above it and +-inf) and K4, K5 (injected noise, normal
    and huge) at list sizes 9..32: the capacity-32 instances."""
    from polar_tpu_torch.ops.mc import build_mc_step
    spec = _mixed(factors, K, crc)
    arikan = set(factors) == {2}
    rng = np.random.default_rng(spec.N + L)
    for v in (2.0 * rng.standard_normal((256, spec.N)) + 0.5,
              np.round(3.0 * rng.standard_normal((256, spec.N))),
              _huge(3.0 * rng.standard_normal((256, spec.N)), rng, arikan)):
        x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        for select in (True, False):
            dec = cuda_scl.SclDecoder(spec, L, cuda, select=select)
            _equal(dec.kernel(x), dec.plain(x))
            if not select:
                _same(dec.trajectory(x), dec.plain_trajectory(x))
    step = build_mc_step(spec, L, device=cuda)
    g = rng.standard_normal((256, spec.N))
    for v in (g, np.where(rng.random(g.shape) < 0.3, 1e32, g)):
        noise = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        _same(step.trajectory((7, 8), 0.8, 256, noise),
              step.plain_trajectory((7, 8), 0.8, 256, noise))
        assert torch.equal(step.counts((7, 8), 0.8, 256, noise),
                           step.plain_counts((7, 8), 0.8, 256, noise))


def test_mixed_n1024_k5_matches_plain(cuda):
    """mixed_n1024_scl32 (N=1024 = 16*16*2*2, K=512 + CRC-16, L=32): K5 at
    its capacity-32 l > 2 instance over 600 codewords (two full waves of 264
    on an H100 and a part of one) equals the plain step bit for bit on the
    in-kernel draw at each of the preset's points, and each call launches
    that instance alone, once (`INSTANCES`)."""
    from polar_tpu_torch.models.presets import mixed_n1024_scl32
    from polar_tpu_torch.ops.mc import build_mc_step
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    preset, B = mixed_n1024_scl32(), 600
    step = build_mc_step(preset.spec, 32, device=cuda, counters=True)
    assert step.decoder.kernels.plan("scl_mc_counters", cuda).instance == \
        "scl_mc_counters_big_c32"
    for i, snr in enumerate(preset.ebn0_grid):
        sigma = float(np.float32(ebn0_to_sigma(snr, preset.spec.rate)))
        before = dict(cuda_scl.INSTANCES)
        got = step.counts((i, 1024), sigma, B)
        grew = {k: n - before.get(k, 0) for k, n in cuda_scl.INSTANCES.items()
                if n != before.get(k, 0)}
        assert grew == {"scl_mc_counters_big_c32": 1}
        assert torch.equal(got, step.plain_counts((i, 1024), sigma, B)), snr


def test_mixed_n1024_k1_matches_plain(cuda):
    """mixed_n1024_scl32's own-LLR decode: `build_scl_decoder` takes K1 at
    its capacity-32 l > 2 instance, which equals the plain decoder in u,
    payload, crc_ok and pm over 600 drawn frames at 1.0 dB."""
    from polar_tpu_torch.models.presets import mixed_n1024_scl32
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    spec = mixed_n1024_scl32().spec
    dec = build_scl_decoder(spec, 32, device=cuda)
    assert dec.kernels.plan("scl_decode", cuda).instance == "scl_decode_big_c32"
    _, llr = mc_draw(spec, (9, 1024), float(ebn0_to_sigma(1.0, spec.rate)), 600, cuda)
    before = dict(cuda_scl.INSTANCES)
    _equal(dec.kernel(llr), dec.plain(llr))
    assert cuda_scl.INSTANCES["scl_decode_big_c32"] == before.get("scl_decode_big_c32", 0) + 1


def _launch_once(k, name, cuda, B=3):
    """Launch kernel `name` of the SclKernels `k` once over B codewords of
    random inputs (what it decodes does not matter here)."""
    spec, P, N = k.spec, k.P, k.spec.N
    gen = torch.Generator(device=cuda).manual_seed(B)
    if name == "scl_mc_counters":
        f = {"counters": torch.empty((2, B), dtype=torch.int32, device=cuda)}
    elif name == "scl_decode":
        f = {"u": torch.empty((B, N), dtype=torch.int8, device=cuda),
             "pm": torch.empty(B, device=cuda), "ok": torch.empty(B, dtype=torch.bool, device=cuda)}
    else:
        f = cuda_scl.trajectory_outputs(spec, P, len(cuda_scl.trajectory_spans(spec, P)), B,
                                        cuda, mc=name == "scl_mc_traj")
    if name in ("scl_decode", "scl_decode_traj"):
        f["llr"] = torch.randn((B, N), generator=gen, device=cuda)
    elif name == "scl_subtree":
        f.update(llr=torch.randn((B, P, N), generator=gen, device=cuda),
                 pm_in=torch.zeros((B, P), device=cuda),
                 netp=torch.empty((B, P), dtype=torch.uint8, device=cuda),
                 xblk=torch.empty((B, P, N), dtype=torch.int8, device=cuda))
    else:
        f.update(noise=None, seed0=1, seed1=2, sigma=0.8)
    k.launch(name, B, cuda, **f)


def _plans_hold(cases, cuda):
    """For each (SclKernels, kernel name) of `cases`, on the card: the
    library launches the instance its launch plan names (its table's row
    of that name, which takes the plan's kernel, capacity, threads and
    codewords, or the launch raises), with the plan's dynamic shared memory
    (`scl_smem_bytes`, the library's layout) and static shared memory, and
    the occupancy API gives at least the plan's blocks an SM."""
    lib = cuda_scl.load_library()
    for k, name in cases:
        plan = k.plan(name, cuda)
        where = (k.spec.factors, k.P, name)
        i = cuda_scl.instance_index(plan.instance)
        assert lib.scl_instance_name(i).decode() == plan.instance, where
        before = cuda_scl.LAUNCHES[name]
        _launch_once(k, name, cuda)
        assert cuda_scl.LAUNCHES[name] == before + 1, where
        assert lib.scl_smem_bytes(i, ctypes.byref(k._args(1, cuda))) == plan.smem, where
        assert lib.scl_static_smem_bytes(i) == plan.static, where
        assert k.blocks_per_sm(name, cuda) >= plan.blocks_per_sm, where
    torch.cuda.synchronize()


def test_capacity32_shared_memory_mirror(cuda):
    """The capacity-32 instances launch as their plans say (`_plans_hold`),
    with `Small<32>` (SMALL32_STATIC_BYTES) of static shared memory, and K3
    holds 2 blocks an SM on every mixed_scl32 child at L=32."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops.program import build_program, subtree_items, subtree_spec
    cases = []
    for factors, K, crc in (((2,) * 7, 56, CrcSpec(8, 0x07, 0)),
                            ((16, 2, 2), 20, None)):
        spec = _mixed(factors, K, crc)
        for L in (9, 32):
            k = cuda_scl.SclKernels(spec, L)
            cases += [(k, name) for name in cuda_scl.KERNELS]
            for name in cuda_scl.KERNELS:
                assert k.smem_bytes(name, cuda)[1] == cuda_scl.SMALL32_STATIC_BYTES
    spec = mixed_scl32().spec
    for it in subtree_items(build_program(spec, scl=True), spec):
        if it[0] == "sub":
            k = cuda_scl.SclKernels(subtree_spec(spec, it[2]), 32)
            cases.append((k, "scl_subtree"))
            assert k.blocks_per_sm("scl_subtree", cuda) == 2, it[1]
    _plans_hold(cases, cuda)


def test_big8_shared_memory_mirror(cuda):
    """The general body's capacity-8 instances launch as their plans say
    (`_plans_hold`) at bch_sc, the mixed specs and the golden mixed spec
    (N=512) for L = 1..8, a `Small<8>` a codeword of static shared memory;
    bch_sc's K5 at L = 1 holds 16 blocks of two codewords an SM."""
    from polar_tpu_torch.models.presets import bch_sc
    gspec = load_golden(ROOT / "results" / "golden_mixed_scl_b128.npz")[0]
    specs = [bch_sc().spec, gspec] + [_mixed(*m) for m in _MIXED]
    cases = []
    for spec in specs:
        for L in range(1, 9):
            k = cuda_scl.SclKernels(spec, L)
            cases += [(k, name) for name in cuda_scl.KERNELS]
            for name in cuda_scl.KERNELS:
                plan = k.plan(name, cuda)
                assert plan.static == plan.codewords * cuda_scl.SMALL8_STATIC_BYTES
    _plans_hold(cases, cuda)
    k = cuda_scl.SclKernels(bch_sc().spec, 1)
    assert k.block_threads("scl_mc_counters", cuda) == 32
    assert k.block_codewords("scl_mc_counters", cuda) == 2
    assert k.blocks_per_sm("scl_mc_counters", cuda) == 16


def test_clock_build_counts_fork_rounds(cuda):
    """The op-kind clock's round count equals the op program's
    (`kernel_times.fork_rounds`) on capacity-32 decodes, Arikan capacity-8
    decodes (ca_scl's K1 and K5 among them) and bch_sc at L=8 (the general
    body's capacity 8)."""
    from polar_tpu_torch.models.presets import bch_sc
    from polar_tpu_torch.sim.kernel_times import fork_rounds
    dec = cuda_scl.SclDecoder(bch_sc().spec, 8, cuda, select=True)
    x = torch.randn((64, 256), device=cuda)
    dec.kernel(x)
    with cuda_scl.clock_build() as lib:
        dec.kernel(x)
        clk = cuda_scl.read_clock(lib)
    assert clk["blocks"] == 64
    assert clk[cuda_scl.ROUNDS_SLOT] == 64 * fork_rounds(bch_sc().spec, 8) == 64 * 37
    for factors, L in (((2,) * 6, 32), ((16, 2, 2), 17), ((2,) * 6, 8)):
        spec = _mixed(factors, 20, CrcSpec(8, 0x07, 0))
        dec = cuda_scl.SclDecoder(spec, L, cuda, select=True)
        x = torch.randn((64, spec.N), device=cuda)
        dec.kernel(x)
        with cuda_scl.clock_build() as lib:
            dec.kernel(x)
            clk = cuda_scl.read_clock(lib)
        assert clk["blocks"] == 64
        assert clk[cuda_scl.ROUNDS_SLOT] == 64 * fork_rounds(spec, L), (factors, L)
    from polar_tpu_torch.ops.mc import build_mc_step
    spec = ca_scl().spec
    dec = cuda_scl.SclDecoder(spec, 8, cuda, select=True)
    step = build_mc_step(spec, 8, device=cuda, counters=True)
    x = torch.randn((64, spec.N), device=cuda)
    for fn in (lambda: dec.kernel(x), lambda: step.counts((3, 4), 0.8, 64)):
        fn()
        with cuda_scl.clock_build() as lib:
            fn()
            clk = cuda_scl.read_clock(lib)
        assert clk["blocks"] == 64
        assert clk[cuda_scl.ROUNDS_SLOT] == 64 * fork_rounds(spec, 8) == 64 * 220


def test_golden_mixed_replay_on_card(cuda):
    """results/golden_mixed_scl_b128.npz (N=512, (16,2,2,2,2,2), L=8)
    through K1 and through the subtree route (K3 on Arikan children)."""
    spec, L, llrs, u_ref = load_golden(ROOT / "results" / "golden_mixed_scl_b128.npz")
    for kw in ({}, {"subtree_backend": "pallas", "big_stage_backend": "pallas"}):
        out = build_scl_decoder(spec, L, device=cuda, **kw)(llrs)
        assert int((out.u.cpu().numpy() != u_ref).any(axis=1).sum()) == 0


def test_mixed_scl32_children_and_default_route(cuda):
    """mixed_scl32 (N=4096, L=32): K3 == plain on all 13 children; the
    decode kernels' state does not fit a block, and the error names the
    subtree route."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops.program import build_program, subtree_items, subtree_spec
    spec = mixed_scl32().spec
    subs = [it for it in subtree_items(build_program(spec, scl=True), spec)
            if it[0] == "sub"]
    assert len(subs) == 13
    gen = torch.Generator(device=cuda).manual_seed(32)
    for _, _, fr in subs:
        core = cuda_scl.SubtreeKernel(subtree_spec(spec, fr), 32)
        lam = 3.0 * torch.randn((32, 256, 64), generator=gen, device=cuda)
        pm = 4.0 * torch.rand((32, 64), generator=gen, device=cuda)
        _same(core(lam, pm), core.plain(lam, pm))
    dec = build_scl_decoder(spec, 32, device=cuda)
    with pytest.raises(ValueError, match="subtree_backend"):
        dec.kernel(torch.zeros((4, 4096), device=cuda))


# ---- the l > 2 tail-table marginal (csrc/big_stage.cuh) ----

@pytest.mark.parametrize("paths", [1, 32])
def test_stage_kernel_at_mixed_scl32_outer_shapes(cuda, paths):
    """K6 == plain at mixed_scl32's outer launches, (P, n, B) = (paths,
    256, 256), for every input i < 15 (quad tables at i = 5..10, the
    direct fold at 11..14, the trellis below), Gaussian and integer LLRs."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops import cuda_stage
    K = mixed_scl32().spec.kernels[0]
    gen = torch.Generator(device=cuda).manual_seed(paths)
    lam = 2.0 * torch.randn((paths, 16, 256, 256), generator=gen, device=cuda)
    for x in (lam, torch.round(lam)):
        for i in range(15):
            fn = cuda_stage.build_down_kernel(K, i, paths, 256)
            assert torch.equal(fn(x), fn.plain(x)), (paths, i)


def _same_nan(got, ref):
    nan = torch.isnan(ref)
    return torch.equal(nan, torch.isnan(got)) and torch.equal(got[~nan], ref[~nan])


@pytest.mark.parametrize("shape", [(1, 256, 256), (32, 256, 256), (1, 16, 8192),
                                   (8, 16, 8192), (1, 1, 8192), (8, 1, 8192)])
def test_stage_kernel_trellis_inputs(cuda, shape):
    """K6 == plain at every trellis input i < 5 of the 16x16 kernel, at
    mixed_scl32's outer shapes (P, n, B) = (1 | 32, 256, 256) and bch_sc's
    hybrid shapes (1 | 8, 16 | 1, 8192), on Gaussian, integer, huge (+-1e30,
    4e30) and +-inf inputs (one a (path, position, codeword): where both
    hypotheses cost inf, inf - inf is NaN in both); at the rule's lanes and
    at every other lane count of the input (R = S / lanes states a lane)."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops import cuda_stage
    K = mixed_scl32().spec.kernels[0]
    paths, n, B = shape
    rng = np.random.default_rng(paths * n)
    g = 2.0 * rng.standard_normal((paths, 16, n, B)).astype(np.float32)
    inf = _huge(g, rng, False)
    at = rng.integers(0, 16, (paths, n, B))
    np.put_along_axis(inf, at[:, None], np.where(
        rng.random((paths, 1, n, B)) < 0.5, np.inf, -np.inf), axis=1)
    for v in (g, np.round(g), _huge(g, rng, False), inf):
        x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        for i in range(5):
            fn = cuda_stage.build_down_kernel(K, i, paths, n)
            ref = fn.plain(x)
            assert _same_nan(fn(x), ref), (shape, i)
            if paths * n * B <= 1 << 17:
                lanes = 1
                while lanes <= 2 << i:
                    assert _same_nan(fn.kernel_call(x, lanes), ref), (shape, i, lanes)
                    lanes *= 2


@pytest.mark.parametrize("i", [4, 5])
def test_stage_kernel_past_32bit_thread_index(cuda, i):
    """K6 at mixed_scl32's outer shape with B = 33,024: P*n*B*lanes is over
    2^32 threads (16 table lanes at i = 5; at the trellis input i = 4 the
    rule gives one lane an element, and no shape that fits the card's
    memory reaches 2^31 elements, so the trellis kernel runs its largest
    group, 32 lanes, through the library), so the launcher splits it into
    launches of at most 2^31 threads, starting mid-row. The elements around
    every split and the last ones == plain; at i = 4 the rule's one launch
    too."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops import cuda_stage
    K = mixed_scl32().spec.kernels[0]
    P, n, B = 32, 256, 129 * 256
    E = P * n * B
    fn = cuda_stage.build_down_kernel(K, i, P, n)
    lanes = cuda_stage.lanes_for(cuda_stage.big_kernel(K), i, E)
    if i == 4:
        assert lanes == 1 and E < 1 << 31
        lanes = 32
    assert E * lanes > 1 << 32
    gen = torch.Generator(device=cuda).manual_seed(i)
    lam = torch.randn((P, 16, n, B), generator=gen, device=cuda).mul_(2.0)
    out = fn.kernel_call(lam, lanes)
    if i == 4:
        assert torch.equal(fn(lam), out)
    one = cuda_stage.build_down_kernel(K, i, 1, n)
    starts = list(range(0, E, (1 << 31) // lanes)) + [E - 1]
    assert len(starts) > 3
    for e0 in starts:
        p, r = divmod(e0, n * B)
        b0 = min(max(r % B - 128, 0), B - 256)
        x = lam[p:p + 1, :, :, b0:b0 + 256].contiguous()
        assert torch.equal(out[p:p + 1, :, b0:b0 + 256], one.plain(x)), (i, e0)
    del lam, out
    torch.cuda.empty_cache()


@pytest.mark.parametrize("quant", [False, True])
def test_subtree_kernel_16x2x2_child_at_L32(cuda, quant):
    """K3 == plain on the (16,2,2) children of (2,16,2,2) at L=32: integer
    LLRs and metrics give many tied columns, maxima and candidates."""
    from polar_tpu_torch.ops.program import build_program, subtree_items, subtree_spec
    spec = _mixed((2, 16, 2, 2), 40, CrcSpec(8, 0x07, 0))
    subs = [it for it in subtree_items(build_program(spec, scl=True), spec)
            if it[0] == "sub"]
    assert subs
    gen = torch.Generator(device=cuda).manual_seed(16)
    for _, _, fr in subs:
        core = cuda_scl.SubtreeKernel(subtree_spec(spec, fr), 32)
        assert core.spec.factors == (16, 2, 2)
        lam = 3.0 * torch.randn((32, core.spec.N, 512), generator=gen, device=cuda)
        pm = 4.0 * torch.rand((32, 512), generator=gen, device=cuda)
        if quant:
            lam, pm = torch.round(lam), torch.round(pm)
        _same(core(lam, pm), core.plain(lam, pm))


def test_mixed_scl32_route_matches_plain_route(cuda):
    """mixed_scl32 at B=256 and 1.25 dB: the K3 route (13 K3 and 15 K6
    launches) == the plain route, every field."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.ops.scl import build_plain_scl_decoder
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    spec = mixed_scl32().spec
    sigma = float(ebn0_to_sigma(1.25, spec.rate))
    _, llr = mc_draw(spec, (26, 6), sigma, 256, cuda)
    route = build_scl_decoder(spec, 32, device=cuda, subtree_backend="pallas",
                              big_stage_backend="pallas")
    before = cuda_scl.LAUNCHES["scl_subtree"]
    out = route(llr)
    assert cuda_scl.LAUNCHES["scl_subtree"] == before + 13
    _equal(out, build_plain_scl_decoder(spec, 32)(llr))


# ---- the op program's walk as one CUDA graph (ops/scl.py ProgramDecoder) ----

def _replayed(dec, llr, launches):
    """dec(llr) on a batch size dec has seen: one replay, no capture, and
    `launches` {kernel: count} added to LAUNCHES. Returns the result."""
    from polar_tpu_torch.ops.scl import GRAPHS
    graphs = dict(GRAPHS)
    before = {k: _launches(k) for k in launches}
    out = dec(llr)
    assert GRAPHS == {"captures": graphs["captures"],
                      "replays": graphs["replays"] + 1}
    assert {k: _launches(k) - before[k] for k in launches} == launches
    return out


@pytest.mark.parametrize("seed", [(20, 1), (20, 2)])
def test_mixed_scl32_replay_equals_walk(cuda, seed):
    """mixed_scl32 at B=256 and 1.25 dB through the K3 route: a replayed
    decode == the eager walk (`ProgramDecoder.walk`), u, payload, crc_ok
    and pm bit for bit; a replay counts its 13 K3 and 15 K6 launches."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    spec = mixed_scl32().spec
    sigma = float(ebn0_to_sigma(1.25, spec.rate))
    dec = build_scl_decoder(spec, 32, device=cuda, subtree_backend="pallas",
                            big_stage_backend="pallas")
    dec(mc_draw(spec, (seed[0], seed[1] + 100), sigma, 256, cuda)[1])
    _, llr = mc_draw(spec, seed, sigma, 256, cuda)
    out = _replayed(dec, llr, {"scl_subtree": 13, "stage_down": 15})
    _equal(out, dec.walk(llr))


def test_bch_sc_hybrid_replay_equals_walk(cuda):
    """The bch_sc hybrid (K6 for each of its 105 trellis/table DOWNs) at
    B=96: a replay == the eager walk and the decode kernel."""
    from polar_tpu_torch.models.presets import bch_sc
    spec = bch_sc().spec
    gen = torch.Generator(device=cuda).manual_seed(96)
    x0, x = (2.0 * torch.randn((96, 256), generator=gen, device=cuda) + 1.0
             for _ in range(2))
    dec = build_scl_decoder(spec, 1, device=cuda, big_stage_backend="pallas")
    dec(x0)
    out = _replayed(dec, x, {"stage_down": 105})
    _equal(out, dec.walk(x))
    _equal(out, build_scl_decoder(spec, 1, device=cuda)(x))


def test_walk_graph_per_batch_and_fresh_results(cuda):
    """The first decode of a batch size walks eagerly and captures; later
    decodes, by this decoder or another of the same key, replay. A result
    held from one decode is unchanged by the next; a second batch size
    captures a second graph; the trajectory form returns fresh tensors
    too. Every result == the eager walk's."""
    from polar_tpu_torch.ops.program import build_program, subtree_items
    from polar_tpu_torch.ops.scl import GRAPHS, ProgramDecoder
    spec = _mixed((16, 2, 2), 20, CrcSpec(8, 0x07, 0), seed=7)
    n_subs = sum(it[0] == "sub" for it in subtree_items(build_program(spec, scl=True),
                                                         spec))
    kw = dict(device=cuda, subtree_backend="pallas", big_stage_backend="pallas")
    dec = build_scl_decoder(spec, 5, **kw)
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs = [2.0 * torch.randn((40, spec.N), generator=gen, device=cuda)
          for _ in range(3)]
    graphs = dict(GRAPHS)
    first = dec(xs[0])
    assert GRAPHS == {"captures": graphs["captures"] + 1,
                      "replays": graphs["replays"]}
    launches = {"scl_subtree": n_subs}
    held = _replayed(dec, xs[1], launches)
    kept = [t.clone() for t in held]
    other = _replayed(build_scl_decoder(spec, 5, **kw), xs[2], launches)
    for a, b in zip(held, kept):
        assert torch.equal(a, b)
    for x, out in zip(xs, (first, held, other)):
        _equal(out, dec.walk(x))
    small = xs[0][:24]
    graphs = dict(GRAPHS)
    dec(small)
    assert GRAPHS["captures"] == graphs["captures"] + 1
    _equal(_replayed(dec, small, launches), dec.walk(small))
    traj = ProgramDecoder(spec, 5, cuda, "trajectory", trajectory=True,
                          subtree=True, stage_kernel=True)
    traj(xs[0])
    held = _replayed(traj, xs[1], launches)
    kept = [t.clone() for t in held]
    _same(traj(xs[2]), traj.walk(xs[2]))
    _same(held, kept)
    _same(held, traj.walk(xs[1]))


def test_walk_graph_shared_by_threads(cuda):
    """Eight threads decode their own LLRs through one captured graph, six
    times each, with a short switch interval: every result == the eager
    walk's (a copy-in, replay and clone-out of one thread never interleave
    with another's)."""
    import concurrent.futures
    import sys
    spec = _mixed((2, 16, 2), 14, CrcSpec(8, 0x07, 0), seed=11)
    dec = build_scl_decoder(spec, 3, device=cuda, subtree_backend="pallas",
                            big_stage_backend="pallas")
    gen = torch.Generator(device=cuda).manual_seed(11)
    xs = [2.0 * torch.randn((33, spec.N), generator=gen, device=cuda)
          for _ in range(8)]
    refs = [dec.walk(x) for x in xs]
    dec(xs[0])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(lambda x: [dec(x) for _ in range(6)], x)
                       for x in xs]
            outs = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for ref, got in zip(refs, outs):
        for out in got:
            _equal(out, ref)


# ---- the Arikan capacity-8 body (K1, K2, K4, K5 of Arikan specs, P <= 8) ----

def _all_four(spec, L, cuda, llr, noise, sigma):
    """K1, K2 (+ epilogue) on llr and K4, K5 on noise == plain, bit for bit."""
    from polar_tpu_torch.ops.mc import build_mc_step
    dec = cuda_scl.SclDecoder(spec, L, cuda, select=True)
    _equal(dec.kernel(llr), dec.plain(llr))
    tdec = cuda_scl.SclDecoder(spec, L, cuda, select=False)
    traj = tdec.trajectory(llr)
    _same(traj, tdec.plain_trajectory(llr))
    _equal(tdec.epilogue(*traj), tdec.plain(llr))
    step = build_mc_step(spec, L, device=cuda)
    B = noise.shape[0]
    _same(step.trajectory((5, 6), sigma, B, noise),
          step.plain_trajectory((5, 6), sigma, B, noise))
    assert torch.equal(step.counts((5, 6), sigma, B, noise),
                       step.plain_counts((5, 6), sigma, B, noise))


# the Arikan specs of the body's tests: two small codes and ca_scl (N=1024)
# at the main path's batch
_ARIKAN8 = [(64, 28, CrcSpec(8, 0x07, 0), 1024),
            (2048, 1000, CrcSpec(16, 0x1021, 0), 1024),
            (1024, None, None, 8192)]


def _arikan8_spec(N, K, crc):
    return ca_scl().spec if K is None else _spec(N, K, crc)


@pytest.mark.parametrize("L", range(1, 9))
@pytest.mark.parametrize("N,K,crc,B", _ARIKAN8)
def test_arikan8_kernels_on_integer_llrs(cuda, N, K, crc, B, L):
    """Integer LLRs and integer noise (sigma = 1): dense ties in metrics and
    in the least-reliable positions, at every P = 1..8; N = 2048 has 33
    path maps, more than the warp's 32 lanes; ca_scl at B=8192."""
    rng = np.random.default_rng(7 * N + L)
    llr = torch.as_tensor(np.round(2.0 * rng.standard_normal((B, N))),
                          dtype=torch.float32, device=cuda)
    noise = torch.as_tensor(np.round(1.5 * rng.standard_normal((B, N))),
                            dtype=torch.float32, device=cuda)
    _all_four(_arikan8_spec(N, K, crc), L, cuda, llr, noise, 1.0)


@pytest.mark.parametrize("L", range(1, 9))
def test_arikan8_kernels_on_ca_scl_at_0db(cuda, L):
    """ca_scl with noise at 0 dB, B=8192: many R1/SPC flips and diverged
    paths."""
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    spec = ca_scl().spec
    sigma = float(ebn0_to_sigma(0.0, spec.rate))
    gen = torch.Generator(device=cuda).manual_seed(50 + L)
    noise = torch.randn((8192, spec.N), generator=gen, device=cuda)
    _, llr = mc_draw(spec, (9, 10), sigma, 8192, cuda, noise)
    _all_four(spec, L, cuda, llr, noise, sigma)


@pytest.mark.parametrize("L", range(1, 9))
@pytest.mark.parametrize("N,K,crc,B", [(128, 56, CrcSpec(16, 0x1021, 0), 1024),
                                       (1024, None, None, 8192)])
def test_arikan8_kernels_on_huge_magnitudes(cuda, N, K, crc, B, L):
    """LLRs at +-1e30, above it and one +-inf a codeword (no inf - inf in
    a g step): the selection's rule at 1e30 equals extract_mins' rounds,
    also where the n = 64 and 128 nodes of ca_scl select by extraction."""
    rng = np.random.default_rng(30 + L)
    x = 3.0 * rng.standard_normal((B, N))
    pick = rng.random(x.shape)
    x = np.where(pick < 0.3, np.sign(x) * 1e30, x)
    x = np.where((pick > 0.3) & (pick < 0.35), np.sign(x) * 4e30, x)
    x[np.arange(B), rng.integers(0, N, B)] = np.inf * np.sign(rng.standard_normal(B))
    llr = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    noise = torch.as_tensor(np.where(pick < 0.3, 1e32, rng.standard_normal(x.shape)),
                            dtype=torch.float32, device=cuda)
    _all_four(_arikan8_spec(N, K, crc), L, cuda, llr, noise, 0.8)


def test_arikan8_shared_memory_mirror(cuda):
    """The Arikan capacity-8 instances launch as their plans say
    (`_plans_hold`) at N = 16 .. 4096 for L = 1..8, with `Fast`
    (FAST_STATIC_BYTES) of static shared memory; ca_scl's K5 fits 8 blocks
    of 128 threads an SM and K1 10 of 64, and the card holds exactly
    those."""
    cases = []
    for N in (16, 64, 1024, 2048, 4096):
        spec = ca_scl().spec if N == 1024 else _spec(N, N // 2, None)
        for L in range(1, 9):
            k = cuda_scl.SclKernels(spec, L)
            cases += [(k, name) for name in ("scl_decode", "scl_decode_traj", "scl_mc_traj",
                                             "scl_mc_counters")]
            for _, name in cases[-4:]:
                assert k.smem_bytes(name, cuda)[1] == cuda_scl.FAST_STATIC_BYTES
    _plans_hold(cases, cuda)
    k = cuda_scl.SclKernels(ca_scl().spec, 8)
    assert k.block_threads("scl_mc_counters", cuda) == 128
    assert k.blocks_per_sm("scl_mc_counters", cuda) == 8
    assert k.block_threads("scl_decode", cuda) == 64
    assert k.blocks_per_sm("scl_decode", cuda) == 10


# ~50 ms of torch.cuda._sleep at an H100's SM clock (up to 1.98 GHz)
SLEEP_CYCLES = 100_000_000

# one rank of the 2-card NCCL run: the sharded fused step on its card
_NCCL_WORKER = r"""
import json, sys
import torch.distributed as dist
from polar_tpu_torch.construction.ga import construct_ga
from polar_tpu_torch.models.polar import CodeSpec, CrcSpec
from polar_tpu_torch.parallel.mesh import (init_multihost, make_batch_mesh,
                                           sharded_mc_step)
from polar_tpu_torch.sim.harness import make_mc_step

mask = tuple(int(v) for v in construct_ga(64, 24, 2.0))
spec = CodeSpec(N=64, K=16, factors=(2,) * 6, frozen_mask=mask,
                crc=CrcSpec(width=8, poly=0x07))
assert init_multihost("cuda")
mesh = make_batch_mesh()
step = sharded_mc_step(make_mc_step(spec, 4, backend="fused"), mesh)
out = step(3, 0, 5, 0.9, 4096)
print("RESULT " + json.dumps({"rank": mesh.rank, "device": str(mesh.device),
                              "frames": out["frames"],
                              "counts": out["counts"].tolist()}), flush=True)
dist.destroy_process_group()
"""


def test_fetch_waits_for_its_own_call(cuda):
    """run_sweep's fetch of call n returns while call n+1 still runs: it
    waits on call n's event, not on the stream."""
    from polar_tpu_torch.sim.harness import CounterCopies
    copies = CounterCopies(2, cuda)
    first = torch.tensor([3, 4], dtype=torch.int64, device=cuda)
    second = torch.tensor([5, 6], dtype=torch.int64, device=cuda)
    torch.cuda.synchronize()
    call_n = copies.start(1, first)
    torch.cuda._sleep(SLEEP_CYCLES)
    call_n1 = copies.start(1, second + 0)
    assert call_n.counts() == (3, 4)
    assert not call_n1.event.query()
    assert call_n1.counts() == (5, 6)


def test_sharded_step_over_two_cards_nccl(cuda, tmp_path):
    """Two ranks, one card each, over NCCL: the all-reduced counters ==
    the sum of each rank's step computed on one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import json
    from polar_tpu_torch.parallel.mesh import launch
    from polar_tpu_torch.sim.harness import make_mc_step
    script = tmp_path / "worker.py"
    script.write_text(_NCCL_WORKER)
    res = sorted((json.loads(line[len("RESULT "):]) for line in
                  launch(2, [str(script)], timeout=600).splitlines()
                  if line.startswith("RESULT ")), key=lambda r: r["rank"])
    spec = _spec(64, 16, CrcSpec(8, 0x07, 0))
    step = make_mc_step(spec, 4, backend="fused", device=cuda)
    own = [step(3, 0, 5, 0.9, 4096, rank=r) for r in (0, 1)]
    total = [sum(int(o[f]) for o in own) for f in ("frame_errors", "bit_errors")]
    assert [r["device"] for r in res] == ["cuda:0", "cuda:1"]
    for r in res:
        assert r["frames"] == 2 * 4096
        assert r["counts"] == total


def test_profile_traces_the_kernels(cuda, tmp_path, capsys):
    """sweep_cli --profile on the card: a trace with the fused step's
    kernel, read by trace_summary."""
    import json
    from polar_tpu_torch.sim import sweep_cli
    from polar_tpu_torch.sim.kernel_times import trace_summary
    sweep_cli.main(["--preset", "sweep", "--backend", "fused", "--snr", "2.0",
                    "--frames", "32768", "--per-device-batch", "8192",
                    "--profile", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["summary"][0]["frames"] == 32768
    s = trace_summary(tmp_path / "trace_rank0.json")
    assert 0 < s["busy_share"] <= 1
    assert "scl_mc_counters" in s["kernels"][0]["name"]
    assert s["kernels"][0]["launches"] == 4


# the decoder knobs: min-sum knobs are bit for bit on the card; exp/log1p
# (f_mode="exact", pm_mode="smooth") and bfloat16 keep u, payload and
# crc_ok, pm within allclose(rtol=1e-5, atol=1e-4). f_mode="exact" is the
# exception for u: its f (kernels/arikan.f_exact, the JAX package's form)
# cancels for small inputs, so its decisions follow libm's last ulp; the
# card may differ from the CPU on as many frames as a 1-ulp change of the
# input LLRs flips on the CPU itself, twice over, plus 1% of the frames.
_KNOBS = [({"genie": True}, True), ({"fast": False}, True),
          ({"fast_r1_scl": False}, True), ({"unroll": False}, True),
          ({"f_mode": "exact"}, False), ({"pm_mode": "smooth"}, False),
          ({"llr_dtype": torch.bfloat16}, False)]


def _knob_close(a, b, exact, allowed=0):
    """a decoded on the card, b on the CPU; `allowed` frames may differ in
    u, payload or crc_ok (pm is compared on the others)."""
    a = type(a)(*(t.cpu() for t in a))
    if exact:
        _equal(a, b)
        return
    agree = ((a.u == b.u).all(dim=1) & (a.payload == b.payload).all(dim=1)
             & (a.crc_ok == b.crc_ok))
    assert int((~agree).sum()) <= allowed
    torch.testing.assert_close(a.pm[agree], b.pm[agree], rtol=1e-5, atol=1e-4)


_KNOB_SPECS = [((2,) * 6, 24, 4, CrcSpec(8, 0x07, 0)), ((16, 2), 12, 2, None),
               ((2, 16), 10, 1, None)]
_KNOB_CASES = [(sp, knob, exact) for sp in _KNOB_SPECS for knob, exact in _KNOBS
               if sp[2] == 1 or "genie" not in knob]


@pytest.mark.parametrize("case", _KNOB_CASES,
                         ids=[f"{sp[0]}-L{sp[2]}-{k}" for sp, k, _ in _KNOB_CASES])
def test_knob_route_on_card_matches_cpu(cuda, case):
    """Each knob through build_scl_decoder on the card (the op program, the
    stage kernel for l > 2 min-sum DOWNs) == the same knob on the CPU;
    the decode kernels K1/K2 are not launched. Genie at list size 1."""
    from polar_tpu_torch.ops import cuda_stage
    from polar_tpu_torch.ops.scl import ProgramDecoder
    (factors, K, L, crc), knob, exact = case
    N = int(np.prod(factors))
    mask = np.ones(N, np.uint8)
    mask[np.random.default_rng(N).permutation(N)[:K + (crc.width if crc else 0)]] = 0
    spec = CodeSpec(N=N, K=K, factors=factors, frozen_mask=tuple(int(v) for v in mask),
                    crc=crc)
    x = torch.as_tensor(2.0 * np.random.default_rng(L).standard_normal((1024, N)) + 1.0,
                        dtype=torch.float32)
    dec = build_scl_decoder(spec, L, device=cuda, big_stage_backend="pallas", **knob)
    ref = build_scl_decoder(spec, L, device="cpu", big_stage_backend="pallas", **knob)
    allowed = 0
    if "f_mode" in knob:
        up = torch.nextafter(x, torch.full_like(x, float("inf")))
        allowed = 2 * int((ref(x).u != ref(up).u).any(dim=1).sum()) + 11
    assert isinstance(dec, ProgramDecoder) and "knobs" in dec.route
    before = dict(cuda_scl.LAUNCHES)
    k6 = cuda_stage.LAUNCHES["stage_down"]
    out = dec(x)
    assert cuda_scl.LAUNCHES == before
    assert (cuda_stage.LAUNCHES["stage_down"] > k6) == (
        any(f > 2 for f in factors) and knob.get("f_mode") != "exact")
    _knob_close(out, ref(x), exact, allowed)


def test_genie_bch_with_stage_kernel_matches_cpu(cuda):
    """The genie decoder of the 16x16 eBCH code (construct_mc's decoder
    for bch_n256) launches K6 for every i < 15 DOWN of the unclassified
    program (15 + 16 x 15) and equals the CPU genie decode."""
    from polar_tpu_torch.construction.montecarlo import genie_decoder
    from polar_tpu_torch.ops import cuda_stage
    x = 2.0 * np.random.default_rng(7).standard_normal((2048, 256)) + 1.0
    before = cuda_stage.LAUNCHES["stage_down"]
    out = genie_decoder((16, 16), cuda)(x)
    assert cuda_stage.LAUNCHES["stage_down"] == before + 15 + 16 * 15
    _knob_close(out, genie_decoder((16, 16), torch.device("cpu"))(x), exact=True)


def test_construct_mc_on_card_matches_cpu(cuda):
    """The same Philox keys on the card and on the CPU: leaf error counts
    apart in at most 1 frame in 10^4 (libm's last ulp in Box-Muller)."""
    from polar_tpu_torch.construction import montecarlo as mc
    frames, batch = 1 << 14, 1 << 12
    card = mc.mc_leaf_error_rates((16,), 2.0, 0.5, frames=frames, batch=batch,
                                  device=cuda)
    cpu = mc.mc_leaf_error_rates((16,), 2.0, 0.5, frames=frames, batch=batch,
                                 device="cpu")
    assert np.abs(card - cpu).max() * frames <= max(1, frames // 10_000)
    mask = mc.construct_mc((16,), 8, 2.0, frames=frames, device=cuda)
    assert mask.sum() == 8 and mask[15] == 0 and mask[0] == 1


def _golden_routes():
    from polar_tpu_torch.sim.golden import RECORDS
    return [(name, label, kw, kernel) for name, rec in RECORDS.items()
            for label, kw, kernel in rec.routes]


def _launches(kernel):
    from polar_tpu_torch.ops import cuda_stage
    return {**cuda_scl.LAUNCHES, **cuda_stage.LAUNCHES}[kernel]


@pytest.mark.parametrize("name,route,kw,kernel", _golden_routes(),
                         ids=[f"{n}-{r}" for n, r, _, _ in _golden_routes()])
def test_golden_record_replays_on_card(cuda, name, route, kw, kernel):
    """Each record of polar_tpu_torch/records/ (the independent C++
    decoder's decisions) through each of its routes on the card: 0
    mismatching frames, and the route's kernel launched."""
    from polar_tpu_torch.sim.golden import RECORDS, record_path, replay_check
    before = _launches(kernel)
    res = replay_check(record_path(name), device=cuda, **kw)
    assert res == {"frames": RECORDS[name].frames, "mismatch_frames": 0,
                   "mismatch_bits": 0}
    assert _launches(kernel) > before


def test_host_codec_built_here_equals_committed_record(cuda, tmp_path):
    """The C++ codec built with this machine's g++ re-records the first 8
    frames of golden_c32_subtree.npz to the committed decisions."""
    from polar_tpu_torch.sim.golden import (load_golden, record_golden,
                                            record_path)
    spec, L, llrs, u_ref = load_golden(record_path("golden_c32_subtree"))
    u = record_golden(spec, L, llrs[:8], tmp_path / "again.npz")
    assert np.array_equal(u, u_ref[:8])


# decode_bench options and the kernels one call of the row launches
_BENCH_ROWS = [
    (["--preset", "ca_scl", "--backend", "fused"], {"scl_mc_counters": 1}),
    (["--preset", "arikan_sc", "--backend", "pallas"], {"scl_decode_traj": 1}),
    (["--preset", "bch_sc", "--backend", "xla"], {"scl_decode_traj": 1}),
    (["--preset", "bch_sc", "--backend", "xla", "--list-size", "8"],
     {"scl_decode": 1}),
    (["--preset", "bch_sc", "--backend", "xla", "--big-stage", "pallas"],
     {"stage_down": 105}),
    (["--preset", "mixed_scl32", "--backend", "xla", "--subtree", "pallas",
      "--big-stage", "pallas"], {"scl_subtree": 13, "stage_down": 15}),
]


@pytest.mark.parametrize("argv,per_call", _BENCH_ROWS,
                         ids=["-".join(a[1::2]) for a, _ in _BENCH_ROWS])
def test_decode_bench_row_on_card(cuda, argv, per_call):
    """Each decode_bench row at B=256, 2 reps on the card: its timed window
    launched its route's kernels twice each and nothing else."""
    from polar_tpu_torch.benchmarks import decode_bench
    rec = decode_bench.run(argv + ["--batch", "256", "--reps", "2"])
    assert rec["launches"] == {k: 2 * n for k, n in per_call.items()}
    assert rec["codewords_per_s"] == 256 / rec["ms_per_decode"] * 1e3 > 0
    assert rec["device"] == torch.cuda.get_device_name(0) and rec["card"]
