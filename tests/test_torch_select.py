"""The Arikan capacity-8 body's fork and selection (csrc/scl_decode.cu
`fork_rank` and the R1/SPC rank pass), as plain PyTorch models, against
the plain decoder's `fork2` and `extract_mins` (ops/scl.py); and the
Python mirror of the body's shared-memory layout.

The kernel itself runs on the card (tests/test_torch_cuda.py); these
models state its algorithm: a fork ranks each of the 2P candidates by
(metric, c) against the whole table and scatters the survivors by rank;
the selection ranks each input by (|v|, j) in one pass, and from the
first rank whose |v| is at or above 1e30 repeats the rounds' choice of a
position already marked 1e30.
"""
import numpy as np
import pytest
import torch

from polar_tpu_torch.models import presets
from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.ops.scl import BIG, extract_mins, fork2

LIST_SIZES = (1, 2, 3, 4, 5, 8)
BLOCKS = (2, 4, 8, 16, 32, 64, 128)
KINDS = ("random", "integer", "huge")
BATCH = 64
SMEM_PER_SM = 228 * 1024       # an H100 SM's shared memory
RESERVED_PER_BLOCK = 1024      # what the runtime keeps of it a block
SMEM_PER_BLOCK = 232448        # the most a block may use


def rank_fork(pm, pen0, pen1):
    """The kernel's fork: candidate c = bit * P + p ranks by (metric, c)
    against the whole table; survivors go out in rank order."""
    P = pm.shape[0]
    cand = torch.cat([pm + pen0, pm + pen1], dim=0)            # [2P, B]
    c = torch.arange(2 * P)
    before = (cand[None] < cand[:, None]) | (
        (cand[None] == cand[:, None]) & (c[None, :, None] < c[:, None, None]))
    rank = before.sum(1)                                        # [2P, B]
    out = torch.empty_like(cand).scatter_(0, rank, cand)
    src = torch.empty_like(rank).scatter_(0, rank, c[:, None].expand_as(rank))
    return out[:P], src[:P] % P, (src[:P] // P).to(torch.int8)


def rank_select(absl, count: int):
    """The kernel's selection: each input's rank by (|v|, j) in its path;
    ranks < count give the positions. From rank rs = #(|v| < BIG) on, the
    rounds of `extract_mins` choose again one position already marked BIG:
    the lowest of the positions before max(rs, 1) and, when rs >= 1, of
    the one of rank rs if its |v| is exactly BIG."""
    P, n, B = absl.shape
    j = torch.arange(n)
    before = (absl[:, None] < absl[:, :, None]) | (
        (absl[:, None] == absl[:, :, None]) & (j[None, None, :, None] < j[None, :, None, None]))
    rank = before.sum(2)                                        # [P, n, B]
    order = torch.empty_like(rank).scatter_(1, rank, j[None, :, None].expand_as(rank))
    vals = [absl.gather(1, order[:, r:r + 1])[:, 0] for r in range(count)]
    poss = [order[:, r] for r in range(count)]
    rs = (absl < BIG).sum(1)                                    # [P, B]
    start = rs.clamp(min=1)
    e = torch.full_like(rs, n)
    for r in range(count):
        e = torch.where(r < start, torch.minimum(e, poss[r]), e)
    for r in range(1, count):
        e = torch.where((rs == r) & (vals[r] == BIG), torch.minimum(e, poss[r]), e)
    for r in range(count):
        again = (r >= start) & (rs < count)
        poss[r] = torch.where(again, e, poss[r])
        vals[r] = torch.where(again, torch.full_like(vals[r], BIG), vals[r])
    return vals, poss


def _values(rng, kind, shape, signed=True):
    x = 3.0 * rng.standard_normal(shape)
    if kind == "integer":
        x = np.round(x)                   # ties in metrics and positions
    elif kind == "huge":
        pick = rng.random(shape)
        x = np.where(pick < 0.25, np.sign(x) * 1e30, x)
        x = np.where(pick > 0.9, np.sign(x) * np.inf, x)
        x = np.where((pick > 0.25) & (pick < 0.3), np.sign(x) * 3e30, x)
    if not signed:
        x = np.abs(x)
    return torch.as_tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", LIST_SIZES)
def test_rank_fork_matches_fork2(P, kind):
    """Survivors, parents and bits equal `fork2`'s (a stable sort: lax.top_k
    on the negated candidates), ties and infinite metrics included."""
    rng = np.random.default_rng(10 * P + KINDS.index(kind))
    # path metrics and penalties are sums of relus: >= 0, so no inf - inf
    pm, pen0, pen1 = (_values(rng, kind, (P, BATCH), signed=False) for _ in range(3))
    want = fork2(pm, pen0, pen1)
    got = rank_fork(pm, pen0, pen1)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", LIST_SIZES)
def test_rank_select_matches_extract_mins(P, kind):
    """Positions and values of the n_min least reliable inputs equal the
    rounds of `extract_mins` for R1's and SPC's n_min at every block size,
    incl. inputs at +-1e30, above it and +-inf."""
    rng = np.random.default_rng(100 * P + KINDS.index(kind))
    for n in BLOCKS:
        absl = _values(rng, kind, (P, n, BATCH)).abs()
        counts = {min(P - 1, n), min(P, n - 1) + 1 if P > 1 else 1}
        for count in sorted(c for c in counts if c > 0):
            wv, wp = extract_mins(absl, count)
            gv, gp = rank_select(absl, count)
            for r in range(count):
                assert torch.equal(wp[r], gp[r]), (n, count, r)
                assert torch.equal(wv[r], gv[r]), (n, count, r)


def test_rank_select_repeats_a_big_position():
    """The rule at 1e30: once every unchosen |v| is >= 1e30, the rounds
    choose the lowest position already marked 1e30 (or exactly 1e30)."""
    x = torch.tensor([5e30, 1.0, float("inf"), 1e30, 2.0, 1e30]).reshape(1, 6, 1)
    for absl in (x, x.flip(1)):
        wv, wp = extract_mins(absl, 5)
        gv, gp = rank_select(absl, 5)
        assert [int(p) for p in gp] == [int(p) for p in wp]
        assert [float(v) for v in gv] == [float(v) for v in wv]
    _, poss = rank_select(x, 5)
    assert [int(p) for p in poss] == [1, 4, 1, 1, 1]
    _, poss = rank_select(torch.full((1, 4, 1), float("inf")), 3)
    assert [int(p) for p in poss] == [0, 0, 0]


def test_fast_layout_fits_five_blocks_at_ca_scl():
    """K5 (and K1) at ca_scl: 5 x (dynamic + static + reserved) fits an
    SM's 228 KB, where the general body's ~64 KB allowed 3."""
    spec = presets.ca_scl().spec
    assert cuda_scl.arikan8(spec, 8, "scl_mc_counters")
    for kernel in ("scl_mc_counters", "scl_decode", "scl_mc_traj", "scl_decode_traj"):
        dyn = cuda_scl.fast_smem_bytes(spec, 8, kernel)
        assert 5 * (dyn + cuda_scl.FAST_STATIC_BYTES + RESERVED_PER_BLOCK) <= SMEM_PER_SM
    assert cuda_scl.fast_smem_bytes(spec, 8, "scl_mc_counters") == 42456


@pytest.mark.parametrize("N", [16, 32, 64, 1024])
def test_fast_layout_fits_the_arikan_test_specs(N):
    """Every Arikan spec of tests/test_torch_scl.py at L <= 8 goes to the
    Arikan capacity-8 body and fits a block; L = 32 goes to the general
    body; an l > 2 spec and the subtree kernel never go to it."""
    spec = CodeSpec(N=N, K=N // 2, factors=(2,) * int(np.log2(N)),
                    frozen_mask=tuple([1] * (N // 2) + [0] * (N // 2)))
    for L in (1, 2, 3, 4, 8):
        for kernel in ("scl_decode", "scl_decode_traj", "scl_mc_traj", "scl_mc_counters"):
            assert cuda_scl.arikan8(spec, L, kernel)
            dyn = cuda_scl.fast_smem_bytes(spec, L, kernel)
            assert dyn % 4 == 0
            assert dyn + cuda_scl.FAST_STATIC_BYTES <= SMEM_PER_BLOCK
        assert not cuda_scl.arikan8(spec, L, "scl_subtree")
    assert not cuda_scl.arikan8(spec, 32)
    assert not cuda_scl.arikan8(presets.get_preset("bch_sc").spec, 8)
