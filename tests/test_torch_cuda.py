"""The CUDA decode kernel against its plain PyTorch version, on the card.

Run on a machine with an NVIDIA Hopper card (--noconftest: the suite's
conftest imports JAX, which the port's machine need not have):
    pytest --noconftest -m gpu tests/test_torch_cuda.py
Here, without a card, every test skips (decided in the fixture).
The kernel and the plain version sum in the same fixed order, so all four
outputs, pm included, must be equal bit for bit.
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
