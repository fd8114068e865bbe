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


@pytest.mark.parametrize("L", [1, 2, 4, 8])
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


@pytest.mark.parametrize("L", [1, 4])
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


@pytest.mark.parametrize("L", [1, 4, 32])
@pytest.mark.parametrize("factors,K,crc", _SUBTREE)
def test_subtree_kernel_matches_plain(cuda, factors, K, crc, L):
    """Every depth-1 child of more than one op, on a path-bound input
    (a different row and metric a path)."""
    from polar_tpu_torch.ops.program import build_program, subtree_items, subtree_spec
    spec = _mixed(factors, K, crc)
    subs = [it for it in subtree_items(build_program(spec, scl=L > 1), spec)
            if it[0] == "sub"]
    assert subs
    gen = torch.Generator(device=cuda).manual_seed(L)
    for _, _, fr in subs:
        core = cuda_scl.SubtreeKernel(subtree_spec(spec, fr), L)
        lam = 2.5 * torch.randn((L, core.spec.N, 256), generator=gen, device=cuda)
        pm = 3.0 * torch.rand((L, 256), generator=gen, device=cuda)
        before = cuda_scl.LAUNCHES["scl_subtree"]
        got = core(lam, pm)
        assert cuda_scl.LAUNCHES["scl_subtree"] == before + 1
        _same(got, core.plain(lam, pm))


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


@pytest.mark.parametrize("L", [9, 16, 32])
@pytest.mark.parametrize("factors,K,crc", [((2,) * 6, 20, CrcSpec(8, 0x07, 0)),
                                           ((16, 2, 2), 20, CrcSpec(8, 0x07, 0)),
                                           ((2, 16, 2), 14, None)])
def test_capacity32_kernels_match_plain(cuda, factors, K, crc, L):
    """K1, K2 (Gaussian and integer LLRs) and K4, K5 (injected noise) at
    list sizes 9..32: the capacity-32 instances."""
    from polar_tpu_torch.ops.mc import build_mc_step
    spec = _mixed(factors, K, crc)
    rng = np.random.default_rng(spec.N + L)
    for v in (2.0 * rng.standard_normal((256, spec.N)) + 0.5,
              np.round(3.0 * rng.standard_normal((256, spec.N)))):
        x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
        for select in (True, False):
            dec = cuda_scl.SclDecoder(spec, L, cuda, select=select)
            _equal(dec.kernel(x), dec.plain(x))
            if not select:
                _same(dec.trajectory(x), dec.plain_trajectory(x))
    step = build_mc_step(spec, L, device=cuda)
    noise = torch.as_tensor(rng.standard_normal((256, spec.N)), dtype=torch.float32,
                            device=cuda)
    _same(step.trajectory((7, 8), 0.8, 256, noise),
          step.plain_trajectory((7, 8), 0.8, 256, noise))
    assert torch.equal(step.counts((7, 8), 0.8, 256, noise),
                       step.plain_counts((7, 8), 0.8, 256, noise))


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


@pytest.mark.parametrize("i", [4, 5])
def test_stage_kernel_past_32bit_thread_index(cuda, i):
    """K6 at mixed_scl32's outer shape with B = 33,024: P*n*B*lanes is over
    2^32 threads (32 trellis lanes at i = 4, 16 table lanes at i = 5), so
    the launcher splits it into launches of at most 2^31 threads, starting
    mid-row. The elements around every split and the last ones == plain."""
    from polar_tpu_torch.models.presets import mixed_scl32
    from polar_tpu_torch.ops import cuda_stage
    K = mixed_scl32().spec.kernels[0]
    P, n, B = 32, 256, 129 * 256
    E = P * n * B
    lanes = cuda_stage.lanes_for(cuda_stage.big_kernel(K), i, E)
    assert E * lanes > 1 << 32
    gen = torch.Generator(device=cuda).manual_seed(i)
    lam = torch.randn((P, 16, n, B), generator=gen, device=cuda).mul_(2.0)
    out = cuda_stage.build_down_kernel(K, i, P, n)(lam)
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


@pytest.mark.parametrize("L", [3, 5, 7, 8])
@pytest.mark.parametrize("N,K,crc", [(64, 28, CrcSpec(8, 0x07, 0)),
                                     (2048, 1000, CrcSpec(16, 0x1021, 0))])
def test_arikan8_kernels_on_integer_llrs(cuda, N, K, crc, L):
    """Integer LLRs and integer noise (sigma = 1): dense ties in metrics and
    in the least-reliable positions, at odd P and at P = 8; N = 2048 has
    33 path maps, more than the warp's 32 lanes."""
    rng = np.random.default_rng(7 * N + L)
    llr = torch.as_tensor(np.round(2.0 * rng.standard_normal((1024, N))),
                          dtype=torch.float32, device=cuda)
    noise = torch.as_tensor(np.round(1.5 * rng.standard_normal((1024, N))),
                            dtype=torch.float32, device=cuda)
    _all_four(_spec(N, K, crc), L, cuda, llr, noise, 1.0)


def test_arikan8_kernels_on_ca_scl_at_0db(cuda):
    """ca_scl with noise at 0 dB: many R1/SPC flips and diverged paths."""
    from polar_tpu_torch.ops.mc import mc_draw
    from polar_tpu_torch.sim.channel import ebn0_to_sigma
    spec = ca_scl().spec
    sigma = float(ebn0_to_sigma(0.0, spec.rate))
    gen = torch.Generator(device=cuda).manual_seed(50)
    noise = torch.randn((2048, spec.N), generator=gen, device=cuda)
    _, llr = mc_draw(spec, (9, 10), sigma, 2048, cuda, noise)
    _all_four(spec, 8, cuda, llr, noise, sigma)


@pytest.mark.parametrize("L", [1, 4, 8])
def test_arikan8_kernels_on_huge_magnitudes(cuda, L):
    """LLRs at +-1e30, above it and one +-inf a codeword (no inf - inf in
    a g step): the selection's rule at 1e30 equals extract_mins' rounds."""
    spec = _spec(128, 56, CrcSpec(16, 0x1021, 0))
    rng = np.random.default_rng(30 + L)
    x = 3.0 * rng.standard_normal((1024, 128))
    pick = rng.random(x.shape)
    x = np.where(pick < 0.3, np.sign(x) * 1e30, x)
    x = np.where((pick > 0.3) & (pick < 0.35), np.sign(x) * 4e30, x)
    x[np.arange(1024), rng.integers(0, 128, 1024)] = np.inf * np.sign(rng.standard_normal(1024))
    llr = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    noise = torch.as_tensor(np.where(pick < 0.3, 1e32, rng.standard_normal(x.shape)),
                            dtype=torch.float32, device=cuda)
    _all_four(spec, L, cuda, llr, noise, 0.8)


def test_arikan8_shared_memory_mirror(cuda):
    """The library's shared memory of the Arikan capacity-8 instances ==
    the Python mirror (`fast_smem_bytes`, FAST_STATIC_BYTES); ca_scl's
    K5 fits 5 blocks an SM, and the card holds 5."""
    for N, L in ((16, 1), (64, 3), (1024, 8), (4096, 5)):
        spec = ca_scl().spec if N == 1024 else _spec(N, N // 2, None)
        k = cuda_scl.SclKernels(spec, L)
        for name in ("scl_decode", "scl_decode_traj", "scl_mc_traj", "scl_mc_counters"):
            dyn, static = k.smem_bytes(name, cuda)
            assert dyn == cuda_scl.fast_smem_bytes(spec, L, name), (N, L, name)
            assert static == cuda_scl.FAST_STATIC_BYTES
    k = cuda_scl.SclKernels(ca_scl().spec, 8)
    dyn, static = k.smem_bytes("scl_mc_counters", cuda)
    assert 5 * (dyn + static + 1024) <= 228 * 1024
    assert k.blocks_per_sm("scl_mc_counters", cuda) == 5


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
