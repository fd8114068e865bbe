"""The CUDA kernels (scl_decode, scl_decode_traj, scl_mc_traj,
scl_mc_counters) against their plain PyTorch versions, on the card.

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
