"""The l > 2 tail-table marginal as the CUDA kernels compute it
(polar_tpu_torch/csrc/big_stage.cuh `table_max`, shared by K1-K6), modelled
step for step in numpy float32 and held bit for bit against the JAX
package's StageProcessor (CPU).

What the model repeats of the kernel: the columns a group of G lanes walks
(half of them where row l-1 is all ones, each column then standing for
itself and its complement as |corr|), in the kernel's order (each lane's
share in Gray order, by pairs of columns on the quad path, so a column's
parity is one XOR of a generator row away); one parity for both hypotheses
(par1 = par ^ row i); the quad tables, the fixed tree's 4-input subtrees,
looked up at the parity's nibbles and folded by its top levels, or the
direct 16-term fold below the cut-over (an input whose bit in
cuda_stage.big_kernel's `quads` is clear, or fewer than 16 lanes); the
walk's length as `big_kernel` sets it for the kernels; the prior
decisions' coset as an XOR of the lookup index; and fmaxf's max. Inputs: Gaussian, integer-valued (ties and
exact zeros), and +-0.0, 1e30 and +-inf mixed in. Where JAX gives NaN
(inf - inf) the model must give NaN too; everywhere else torch.equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polar_tpu.kernels.bch import build_bch_kernel
from polar_tpu.ops import kernel_proc as j_kp
from polar_tpu_torch.ops import cuda_stage

P, N_POS, B = 2, 2, 8
F32 = np.float32


def _rows(kernel):
    l = kernel.shape[0]
    return [int((kernel[j].astype(np.int64) << np.arange(l)).sum()) for j in range(l)]


def walk_columns(kernel, i: int, G: int, quads: bool) -> list[list[int]]:
    """Per lane g < G: the parities of the columns it walks, in its order
    (the source's `table_max`): a Gray walk of its share, by pairs of
    columns {c, c ^ 1} on the quad-table path."""
    krow = _rows(kernel)
    walk = int(cuda_stage.big_kernel(kernel).walk[i])
    lanes = []
    for g in range(G):
        cnt = walk // G
        c0 = g * cnt
        base = 0
        for b in range(c0.bit_length()):
            if (c0 >> b) & 1:
                base ^= krow[i + 1 + b]
        cols = []
        if quads and cnt > 1:
            for j in range(0, cnt, 2):
                if j:
                    base ^= krow[i + 2 + _ctz(j >> 1)]
                cols += [base, base ^ krow[i + 1]]
        else:
            for j in range(cnt):
                if j:
                    base ^= krow[i + 1 + _ctz(j)]
                cols.append(base)
        lanes.append(cols)
    return lanes


def _ctz(x: int) -> int:
    return (x & -x).bit_length() - 1


def _tree(terms):
    """tree_fold: the fixed pairwise tree ((0+1)+(2+3))+..., float32."""
    terms = list(terms)
    while len(terms) > 1:
        nxt = [(terms[k] + terms[k + 1]).astype(F32)
               for k in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _signed(w, par):
    """t[k] = par_k ? -w[k] : w[k] for every element: w [E, l], par [C]
    -> [l][E, C]."""
    l = w.shape[1]
    bits = (np.asarray(par)[None, :] >> np.arange(l)[:, None]) & 1    # [l, C]
    return [np.where(bits[k][None, :] == 1, -w[:, k:k + 1], w[:, k:k + 1])
            for k in range(l)]


def quad_tables(w):
    """Q [E, l/4, 16]: entry a of quad j = (t0 + t1) + (t2 + t3) over
    inputs 4j..4j+3, signs from the bits of a."""
    E, l = w.shape
    out = np.empty((E, l // 4, 16), F32)
    for j in range(l // 4):
        t = _signed(w[:, 4 * j:4 * j + 4], np.arange(16))
        out[:, j] = ((t[0] + t[1]).astype(F32) + (t[2] + t[3]).astype(F32)).astype(F32)
    return out


def model_table_max(kernel, i: int, w, coset, G: int):
    """(m0, m1) [E] of input i: the kernel's walk over G lanes, fold by
    quad tables or directly, on raw output LLRs w [E, l] whose coset
    masks [E] (bit k: flip output k) enter as an XOR of the parity."""
    l = kernel.shape[0]
    krow = _rows(kernel)
    bk = cuda_stage.big_kernel(kernel)
    walk = int(bk.walk[i])
    absmax = walk < (1 << (l - 1 - i))
    quads = G >= 16 and bool((bk.quads >> i) & 1)
    par = np.array([c for lane in walk_columns(kernel, i, G, quads)
                    for c in lane], np.int64)
    coset = np.asarray(coset, np.int64)
    Q = quad_tables(w) if quads else None
    m = []
    for hyp in (0, krow[i]):
        idx = par[None, :] ^ hyp ^ coset[:, None]                  # [E, C]
        if quads:
            x = [np.take_along_axis(Q[:, j], (idx >> (4 * j)) & 15, axis=1)
                 for j in range(l // 4)]
            corr = _tree(x)
        else:
            bits = (idx[:, None, :] >> np.arange(l)[None, :, None]) & 1   # [E, l, C]
            corr = _tree([np.where(bits[:, k] == 1, -w[:, k:k + 1], w[:, k:k + 1])
                          for k in range(l)])
        if absmax:
            corr = np.abs(corr)
        acc = np.full(w.shape[0], -np.inf, F32)
        for c in range(corr.shape[1]):          # fmaxf: a NaN operand loses
            acc = np.fmax(acc, corr[:, c])
        m.append(acc)
    return m


def model_llr(kernel, i, lam, coset=None, G=16):
    """Input i's LLR [P, n, B] from lam [P, l, n, B] (coset-adjusted, or raw
    with coset [P, n, B] masks)."""
    Pp, l, n, b = lam.shape
    w = np.moveaxis(lam, 1, -1).reshape(-1, l)
    cs = np.zeros(w.shape[0], np.int64) if coset is None else coset.reshape(-1)
    m0, m1 = model_table_max(kernel, i, w, cs, G)
    with np.errstate(invalid="ignore"):        # inf - inf: NaN, as in JAX
        return (F32(0.5) * (m0 - m1).astype(F32)).astype(F32).reshape(Pp, n, b)


def _inputs(kind, l, seed):
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.standard_normal((P, l, N_POS, B))
    if kind == "int":
        x = np.round(x)
    elif kind == "special":
        x = np.round(x)
        x[0, :, 0, :] = 0.0
        x[0, ::3, 1, :] *= -0.0
        x[0, 1, 1, ::2] = -0.0
        x[1, 0, 0, :] = 1e30
        x[1, 3 % l, 0, ::3] = -1e30
        e = rng.integers(0, l, B)              # one +-inf an element
        x[1, e, 1, np.arange(B)] = np.where(np.arange(B) % 2, np.inf, -np.inf)
    return x.astype(F32)


def _same(got, ref):
    got, ref = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(ref))
    nan = torch.isnan(ref)
    return torch.equal(nan, torch.isnan(got)) and torch.equal(got[~nan], ref[~nan])


def _table_cases():
    cases = []
    for l in (4, 8, 16):
        proc = j_kp.StageProcessor(build_bch_kernel(l))
        for i in range(l - 1):
            # every table input; at l < 16 the trellis inputs too, forced
            # to the table (their columns reach the quad path at l = 8)
            if proc.backend[i] == "table" or l < 16:
                cases.append((l, i))
    return cases


@pytest.mark.parametrize("kind", ["normal", "int", "special"])
@pytest.mark.parametrize("l,i", _table_cases())
def test_model_matches_jax_maxcorr(l, i, kind):
    """The model's two maxima and its LLR equal JAX's _maxcorr and
    _llr_static, for every lane count the kernels use (direct fold and
    quad tables)."""
    kernel = build_bch_kernel(l)
    jp = j_kp.StageProcessor(kernel)
    if jp.backend[i] != "table":
        jp.backend[i] = "table"
        jp.tables[i] = j_kp._tail_table(kernel, i)
    lam = _inputs(kind, l, 100 * l + i)
    both = np.stack([lam, lam * jp.row_signs[i][None, :, None, None]])
    ref_m = np.asarray(jp._maxcorr(jnp.asarray(both), i))          # [2, P, n, B]
    ref = np.asarray(jp._llr_static(i, jnp.asarray(lam)))
    walk = len(walk_columns(kernel, i, 1, False)[0])
    w = np.moveaxis(lam, 1, -1).reshape(-1, l)
    for G in (1, 2, 16, 32):
        if G > walk:
            continue
        m0, m1 = model_table_max(kernel, i, w, np.zeros(w.shape[0], np.int64), G)
        for got, r in ((m0, ref_m[0]), (m1, ref_m[1])):
            assert _same(got.reshape(P, N_POS, B), r), (G, kind)
        assert _same(model_llr(kernel, i, lam, G=G), ref), (G, kind)


@pytest.mark.parametrize("i", [5, 9, 12, 14])
def test_coset_as_index_xor(i):
    """Prior decisions' coset flips of the output LLRs equal an XOR of the
    lookup index into tables built from the raw LLRs (the stage-1 tables
    of a child depend only on the input block's row and position)."""
    kernel = build_bch_kernel(16)
    jp = j_kp.StageProcessor(kernel)
    rng = np.random.default_rng(7 + i)
    view = _inputs("int", 16, 50 + i)
    dec = rng.integers(0, 2, (16, P, N_POS, B)).astype(np.int8)
    ref = np.asarray(jp.static_llr(i, jnp.asarray(view), jnp.asarray(dec)))
    signs = np.asarray(jp.coset_signs(jnp.asarray(dec), i))       # [P, l, n, B]
    coset = ((signs < 0).astype(np.int64) << np.arange(16)[None, :, None, None]).sum(1)
    for G in (1, 16):
        if G <= len(walk_columns(kernel, i, 1, False)[0]):
            assert _same(model_llr(kernel, i, view, coset=coset, G=G), ref), G


@pytest.mark.parametrize("l", [4, 8, 16])
def test_walk_covers_each_column_once(l):
    """Every lane count's walk visits each of the walked columns once: the
    parities are those of the message indices below the walk (the upper
    half's complements are |corr|), each lane a contiguous share."""
    kernel = build_bch_kernel(l)
    krow = _rows(kernel)
    assert krow[l - 1] == (1 << l) - 1          # the eBCH kernels' last row
    for i in range(l - 1):
        walk = 1 << (l - 2 - i)
        want = [0]                  # parity of message c, bit b <-> row i+1+b
        for c in range(1, walk):
            want.append(want[c & (c - 1)] ^ krow[i + 1 + _ctz(c)])
        for G in (1, 2, 16, 32, 256):
            if G > walk:            # the kernels' groups never outnumber it
                continue
            for quads in (False, True):
                lanes = walk_columns(kernel, i, G, quads)
                got = [c for lane in lanes for c in lane]
                assert sorted(got) == sorted(want), (i, G, quads)
                assert {len(lane) for lane in lanes} == {walk // G}
        assert cuda_stage.big_kernel(kernel).walk[i] == walk
