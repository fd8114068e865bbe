"""The port's StageProcessor (polar_tpu_torch/ops/kernel_proc.py) and the
plain side of the CUDA stage kernel (ops/cuda_stage.py) against the JAX
package's StageProcessor on the same numpy inputs (CPU).

Min-sum is bit-exact on every input of the 16x16 eBCH kernel, on both
backends (trellis and table): +-1 multiplies, the fixed pairwise tree, and
order-free mins and maxes give the same floats. The exact mode goes
through libm log1p/exp (and an einsum whose order is backend-defined), so
it is held to 1e-6, as f_exact is."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.kernels.bch import build_bch_kernel
from polar_tpu.ops import kernel_proc as j_kp
from polar_tpu_torch.ops import cuda_stage
from polar_tpu_torch.ops import kernel_proc as t_kp

K16 = build_bch_kernel(16)
P, N_POS, B = 2, 4, 8


def _lam(seed, l=16, quant=False, shape=None):
    x = 2.0 * np.random.default_rng(seed).standard_normal(shape or (P, l, N_POS, B))
    return (np.round(x) if quant else x).astype(np.float32)


def _forced_table(proc, kernel, kp):
    l = kernel.shape[0]
    proc.backend = ["table"] * l
    proc.tables = [kp._tail_table(kernel, i) for i in range(l)]
    return proc


@pytest.mark.parametrize("i", range(16))
def test_llr_static_bit_exact(i):
    jp, tp = j_kp.StageProcessor(K16), t_kp.StageProcessor(K16)
    assert tp.backend == jp.backend
    jf = _forced_table(j_kp.StageProcessor(K16), K16, j_kp)
    tf = _forced_table(t_kp.StageProcessor(K16), K16, t_kp)
    for quant in (False, True):
        lam = _lam(i, quant=quant)
        for j, t in ((jp, tp), (jf, tf)):
            ref = np.asarray(j._llr_static(i, jnp.asarray(lam)))
            got = t._llr_static(i, torch.as_tensor(lam)).numpy()
            assert np.array_equal(got, ref), (i, t.backend[i], quant)


@pytest.mark.parametrize("i", [0, 3, 7, 15])
def test_static_and_dynamic_llr_bit_exact(i):
    jp, tp = j_kp.StageProcessor(K16), t_kp.StageProcessor(K16)
    rng = np.random.default_rng(40 + i)
    view = _lam(60 + i)
    dec = rng.integers(0, 2, (16, P, N_POS, B)).astype(np.int8)
    ref = np.asarray(jp.static_llr(i, jnp.asarray(view), jnp.asarray(dec)))
    got = tp.static_llr(i, torch.as_tensor(view), torch.as_tensor(dec)).numpy()
    assert np.array_equal(got, ref)
    got_dyn = tp.dynamic_llr(i, torch.as_tensor(view), torch.as_tensor(dec))
    assert np.array_equal(got_dyn.numpy(), ref)
    assert np.array_equal(tp.coset_signs(torch.as_tensor(dec), i).numpy(),
                          np.asarray(jp.coset_signs(jnp.asarray(dec), i)))
    assert np.array_equal(tp.reencode(torch.as_tensor(dec)).numpy(),
                          np.asarray(jp.reencode(jnp.asarray(dec))))


@pytest.mark.parametrize("l", [2, 4, 8])
def test_small_kernels_bit_exact(l):
    K = build_bch_kernel(l)
    jp, tp = j_kp.StageProcessor(K), t_kp.StageProcessor(K)
    assert tp.backend == jp.backend if l > 2 else True
    rng = np.random.default_rng(l)
    view = _lam(l, l=l, quant=True)
    dec = rng.integers(0, 2, (l, P, N_POS, B)).astype(np.int8)
    for i in range(l):
        ref = np.asarray(jp.static_llr(i, jnp.asarray(view), jnp.asarray(dec)))
        got = tp.static_llr(i, torch.as_tensor(view), torch.as_tensor(dec))
        assert np.array_equal(got.numpy(), ref), (l, i)
    assert np.array_equal(tp.reencode(torch.as_tensor(dec)).numpy(),
                          np.asarray(jp.reencode(jnp.asarray(dec))))


@pytest.mark.parametrize("l", [2, 4, 16])
def test_exact_mode_close(l):
    K = build_bch_kernel(l)
    jp = j_kp.StageProcessor(K, f_mode="exact")
    tp = t_kp.StageProcessor(K, f_mode="exact")
    lam = _lam(7, l=l)
    for i in range(l):
        ref = np.asarray(jp._llr_static(i, jnp.asarray(lam)))
        got = tp._llr_static(i, torch.as_tensor(lam)).numpy()
        if l == 2 or i == l - 1:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
            continue
        # the two log-sum-exps agree to 1e-6; their difference is held to
        # 1e-6 of their magnitude (one ulp of an LSE near 20 is 1.9e-6)
        both = np.stack([lam, lam * tp.row_signs[i][None, :, None, None]])
        lse_j = np.asarray(jp._lsecorr(jnp.asarray(both), i))
        lse_t = tp._lsecorr(torch.as_tensor(both), i).numpy()
        np.testing.assert_allclose(lse_t, lse_j, rtol=1e-6, atol=1e-6)
        scale = np.abs(lse_j).sum(axis=0)
        assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-6), i


def test_tree_corr_and_tail_table_equal():
    lam = _lam(3)
    for i in (5, 9, 14):
        tj, tt = j_kp._tail_table(K16, i), t_kp._tail_table(K16, i)
        assert np.array_equal(tj, tt)
        ref = np.asarray(j_kp.tree_corr(jnp.asarray(lam), tj))
        assert np.array_equal(t_kp.tree_corr(torch.as_tensor(lam), tt).numpy(), ref)
    # the tree, not a left-to-right sum: (1e8 + -1e8) + (1 + 1) = 2
    x = torch.tensor([1e8, -1e8, 1.0, 1.0]).reshape(4, 1, 1)
    assert float(t_kp.tree_corr(x, np.ones((4, 1), np.float32))) == 2.0


def test_chunked_max_equals_one_chunk(monkeypatch):
    """The table max in column chunks of any size gives the same floats."""
    tp = t_kp.StageProcessor(K16)
    lam = torch.as_tensor(_lam(5, quant=True))
    whole = tp._llr_static(5, lam)
    monkeypatch.setattr(t_kp, "_TERM_BUDGET", 3 * lam.numel())
    assert torch.equal(tp._llr_static(5, lam), whole)


@pytest.mark.parametrize("i", [0, 4, 5, 10, 14])
def test_stage_kernel_cpu_is_plain(i):
    """K6's wrapper takes a CPU tensor to the plain version, which is
    StageProcessor._llr_static; the stage_kernel processor gives the same
    floats and counts no launch."""
    lam = torch.as_tensor(_lam(80 + i))
    fn = cuda_stage.build_down_kernel(K16, i, P, N_POS)
    before = cuda_stage.LAUNCHES["stage_down"]
    ref = t_kp.StageProcessor(K16)._llr_static(i, lam)
    assert torch.equal(fn(lam), ref)
    hybrid = t_kp.StageProcessor(K16, stage_kernel=True)
    assert hybrid.stage_kernel and torch.equal(hybrid._llr_static(i, lam), ref)
    assert cuda_stage.LAUNCHES["stage_down"] == before


def test_stage_kernel_tables_and_checks():
    bk = cuda_stage.big_kernel(K16)
    proc = t_kp.StageProcessor(K16)
    for i in range(15):
        if proc.backend[i] == "trellis":
            S, cols = proc.syn[i]
            assert bk.states[i] == S <= 32
            assert list(bk.cols[i])[:16] == list(cols)
            assert cuda_stage.lanes_for(bk, i, 10) == S
        else:
            assert bk.states[i] == 0
            assert 1 <= cuda_stage.lanes_for(bk, i, 8192) <= 32
            # the row l-1 is all ones: half the columns are walked; a walk
            # of >= QUAD_MIN_COLS columns takes a 16-lane group (quad tables)
            walk = bk.walk[i]
            assert walk == 1 << (14 - i)
            quads = walk >= cuda_stage.QUAD_MIN_COLS
            assert bool((bk.quads >> i) & 1) == quads
            many = cuda_stage.lanes_for(bk, i, 1 << 24)
            assert many == (16 if quads else 1)
            assert cuda_stage.lanes_for(bk, i, 8192) <= walk
    for k in range(16):
        assert bk.kcol[k] == sum(int(K16[j, k]) << j for j in range(16))
        assert bk.krow[k] == sum(int(K16[k, j]) << j for j in range(16))
    with pytest.raises(ValueError):
        cuda_stage.build_down_kernel(K16, 15, P, N_POS)
    fn = cuda_stage.build_down_kernel(K16, 3, P, N_POS)
    with pytest.raises(ValueError):
        fn(torch.zeros((P, 16, N_POS + 1, B)))
    with pytest.raises(TypeError):
        fn(torch.zeros((P, 16, N_POS, B), dtype=torch.float64))
