"""The port's trellis module (polar_tpu_torch/kernels/trellis.py) against
the JAX package's on the same numpy inputs (CPU).

The host tables (minimal-trellis transitions, state profiles, syndrome
columns) are equal for every input of the 16x16 eBCH kernel, and the two
device passes give the same floats bit for bit: each alpha update is a
2-operand add and an order-free min in the same section order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.kernels import trellis as j_trellis
from polar_tpu.kernels.bch import build_bch_kernel
from polar_tpu_torch.kernels import trellis as t_trellis

K16 = build_bch_kernel(16)


def _lam(seed, shape, quant=False):
    x = 2.0 * np.random.default_rng(seed).standard_normal(shape)
    return (np.round(x) if quant else x).astype(np.float32)


def _brute_min_cost(tail_basis, lam):
    nf = tail_basis.shape[0]
    msgs = ((np.arange(1 << nf)[:, None] >> np.arange(nf)[None, :]) & 1)
    words = (msgs.astype(np.int64) @ tail_basis.astype(np.int64)) % 2
    pen = np.where(words[:, :, None, None] == 1,
                   np.maximum(lam, 0)[None], np.maximum(-lam, 0)[None])
    return pen.sum(axis=1).min(axis=0)


@pytest.mark.parametrize("i", range(16))
def test_host_tables_equal(i):
    kb = K16.tobytes()
    tj, tt = j_trellis.tail_trellis(kb, 16, i), t_trellis.tail_trellis(kb, 16, i)
    assert tt.s_max == tj.s_max and tt.n == tj.n
    assert tt.state_profile == tj.state_profile
    assert np.array_equal(tt.trans, tj.trans)
    assert t_trellis.tail_syndrome_cols(kb, 16, i) == \
        j_trellis.tail_syndrome_cols(kb, 16, i)
    assert t_trellis.INF == j_trellis.INF


@pytest.mark.parametrize("l", [4, 8])
def test_host_tables_equal_small_kernels(l):
    K = build_bch_kernel(l)
    for i in range(l):
        for lo, hi in [(0, i), (i, l), (1, l - 1)]:
            assert np.array_equal(t_trellis._subcode_basis(K[i + 1:], lo, hi),
                                  j_trellis._subcode_basis(K[i + 1:], lo, hi))
        tj = j_trellis.build_trellis(K[i + 1:], l)
        tt = t_trellis.build_trellis(K[i + 1:], l)
        assert np.array_equal(tt.trans, tj.trans)
        assert tt.state_profile == tj.state_profile


@pytest.mark.parametrize("quant", [False, True])
def test_device_passes_bit_exact(quant):
    kb = K16.tobytes()
    lam = _lam(1, (2, 16, 3, 5), quant)
    for i in range(15):
        S, cols = t_trellis.tail_syndrome_cols(kb, 16, i)
        if S <= 32:
            got = t_trellis.syndrome_min_cost(S, cols, torch.as_tensor(lam))
            ref = j_trellis.syndrome_min_cost(S, cols, jnp.asarray(lam))
            assert np.array_equal(got.numpy(), np.asarray(ref)), i
        if i in (0, 2, 4, 11, 14):
            tr = t_trellis.tail_trellis(kb, 16, i)
            got = t_trellis.min_path_cost(tr, torch.as_tensor(lam))
            ref = j_trellis.min_path_cost(j_trellis.tail_trellis(kb, 16, i),
                                          jnp.asarray(lam))
            assert np.array_equal(got.numpy(), np.asarray(ref)), i


def test_syndrome_form_equals_minimal_form():
    kb = K16.tobytes()
    lam = torch.as_tensor(_lam(2, (3, 16, 2, 4)))
    for i in range(5):
        S, cols = t_trellis.tail_syndrome_cols(kb, 16, i)
        a = t_trellis.syndrome_min_cost(S, cols, lam)
        b = t_trellis.min_path_cost(t_trellis.tail_trellis(kb, 16, i), lam)
        assert torch.equal(a, b), i


def test_min_path_matches_brute_force():
    lam = _lam(0, (1, 16, 2, 3))
    for i in [0, 2, 5, 11, 14]:
        tr = t_trellis.build_trellis(K16[i + 1:], 16)
        got = t_trellis.min_path_cost(tr, torch.as_tensor(lam)).numpy()[0]
        assert np.allclose(got, _brute_min_cost(K16[i + 1:], lam[0]), atol=1e-4), i


def test_state_counts():
    """Inputs 0..4 run as syndrome trellises of 2^(i+1) <= 32 states."""
    kb = K16.tobytes()
    assert [t_trellis.tail_syndrome_cols(kb, 16, i)[0] for i in range(5)] == \
        [2, 4, 8, 16, 32]
    assert t_trellis.build_trellis(K16[1:], 16).s_max == 2
