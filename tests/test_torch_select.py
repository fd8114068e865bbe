"""The capacity-8 fork and selection (csrc/scl_decode.cu `fork_rank` and
the one-pass R1/SPC rank of the general body at L <= 8, whose results the
Arikan capacity-8 body's register fork and selection equal:
tests/test_torch_arikan8.py), as plain PyTorch models, against the plain
decoder's `fork2` and `extract_mins` (ops/scl.py) at every list size 1..8;
and the Python mirror of the Arikan body's shared-memory layout.

The kernel itself runs on the card (tests/test_torch_cuda.py); these
models state its algorithm: a fork ranks each of the 2P candidates by
(metric, c) against the whole table and scatters the survivors by rank;
the selection ranks each input by (|v|, j) in one pass, and from the
first rank whose |v| is at or above 1e30 repeats the rounds' choice of a
position already marked 1e30.

The general body's list capacity 32 (8 < P <= 32) forks from a table in
shared memory (`fork_table`): candidate slot s = bit * 32 + p, NaN where
p >= P; where the path metrics are in order it takes the sorted-half
form of the TPU kernel's `fork2_sorted`, under the body's `pm_sorted`
rule; its selection is the one-pass rank above. The models below state
both forks and hold them to `fork2` and to `jax.lax.top_k`.
"""
import numpy as np
import pytest
import torch

from polar_tpu_torch.models import presets
from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.ops.scl import BIG, extract_mins, fork2

LIST_SIZES = (1, 2, 3, 4, 5, 6, 7, 8)
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
    SM's 228 KB, where the general body's ~64 KB allowed 3; K5's dynamic
    shared memory is 25,176 B since stage 1 is read through the channel row
    (42,456 B before; tests/test_torch_arikan8.py holds the layout)."""
    spec = presets.ca_scl().spec
    assert cuda_scl.arikan8(spec, 8, "scl_mc_counters")
    for kernel in ("scl_mc_counters", "scl_decode", "scl_mc_traj", "scl_decode_traj"):
        dyn = cuda_scl.fast_smem_bytes(spec, 8, kernel)
        assert 5 * (dyn + cuda_scl.FAST_STATIC_BYTES + RESERVED_PER_BLOCK) <= SMEM_PER_SM
    assert cuda_scl.fast_smem_bytes(spec, 8, "scl_mc_counters") == 25176


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


# ---- list capacity 32: the fork table, the sorted-half form, the rule ----

C32_SIZES = (9, 16, 17, 31, 32)
C32_BLOCKS = (2, 4, 8, 16, 32, 512)
SMALL32_MIN_BLOCKS = 2          # K3's __launch_bounds__ at capacity 32


def _slot_table(keep, other):
    """The kernel's table [64, B]: slot p the keep candidate, 32 + p the
    other bit's, NaN for p >= P."""
    P, B = keep.shape
    t = torch.full((64, B), float("nan"))
    t[:P], t[32:32 + P] = keep, other
    return t


def table_fork(pm, pen0, pen1):
    """`fork_table`, general form: slot s ranks by #{slots s2 before s}:
    metric below, or equal at a lower slot (NaN is before nothing); ranks
    < P go out in order, parent s & 31, bit s >> 5."""
    P = pm.shape[0]
    t = _slot_table(pm + pen0, pm + pen1)
    s = torch.arange(64)
    before = (t[None] < t[:, None]) | ((t[None] == t[:, None])
                                       & (s[None, :, None] < s[:, None, None]))
    rank = before.sum(1)                                        # [64, B]
    return _scatter(t, rank, P)


def sorted_fork(pm, pen):
    """`fork_table`, sorted-half form (pm in order by value, then p): rank
    of keep slot p = p + #{B[j] < A[p]}; of slot 32 + p = #{A[j] <= B[p]},
    by the kernel's binary search of six halving steps, + B's rank among
    itself."""
    P, Bn = pm.shape
    A, Bc = pm + 0.0, pm + pen
    ra = torch.arange(P)[:, None] + (Bc[None] < A[:, None]).sum(1)
    k = torch.zeros((P, Bn), dtype=torch.int64)
    for step in (32, 16, 8, 4, 2, 1):
        idx = (k + step - 1).clamp(max=P - 1)
        take = (k + step <= P) & (A.gather(0, idx) <= Bc)
        k = torch.where(take, k + step, k)
    j = torch.arange(P)
    rb = k + ((Bc[None] < Bc[:, None]) | ((Bc[None] == Bc[:, None])
                                          & (j[None, :, None] < j[:, None, None]))).sum(1)
    t = _slot_table(A, Bc)
    rank = torch.full((64, Bn), 64, dtype=torch.int64)
    rank[:P], rank[32:32 + P] = ra, rb
    return _scatter(t, rank, P)


def _scatter(t, rank, P):
    valid = ~torch.isnan(t) & (rank < P)
    out = torch.zeros((P, t.shape[1]))
    src = torch.zeros((P, t.shape[1]), dtype=torch.int64)
    for s in range(64):
        for b in range(t.shape[1]):
            if valid[s, b]:
                out[rank[s, b], b] = t[s, b]
                src[rank[s, b], b] = s
    return out, src & 31, (src >> 5).to(torch.int8)


def _top_k(pm, pen0, pen1):
    """jax.lax.top_k(-cand, P) on the CPU, as the JAX decoder's `_fork2`."""
    import jax
    import jax.numpy as jnp
    P = pm.shape[0]
    cand = jnp.concatenate([jnp.asarray(pm.numpy() + pen0.numpy()),
                            jnp.asarray(pm.numpy() + pen1.numpy())], axis=0)
    vals, idx = jax.lax.top_k(-cand.T, P)
    c = np.asarray(idx.T).astype(np.int64)
    return (torch.as_tensor(-np.asarray(vals.T)), torch.as_tensor(c % P),
            torch.as_tensor((c // P).astype(np.int8)))


def _same(got, *wants):
    for want in wants:
        for w, g in zip(want, got):
            assert torch.equal(w, g)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", C32_SIZES)
def test_table_fork_matches_fork2_and_top_k(P, kind):
    """The general form: survivors, parents and bits equal `fork2`'s and
    `lax.top_k`'s, ties and infinite metrics included."""
    rng = np.random.default_rng(1000 + 10 * P + KINDS.index(kind))
    pm, pen0, pen1 = (_values(rng, kind, (P, 16), signed=False) for _ in range(3))
    _same(table_fork(pm, pen0, pen1), fork2(pm, pen0, pen1), _top_k(pm, pen0, pen1))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", C32_SIZES)
def test_sorted_fork_matches_fork2_and_top_k(P, kind):
    """The sorted-half form on sorted metrics (a fork's output, or the
    decode's [0, 1e30, ...]) equals `fork2(pm, 0, pen)` and `lax.top_k`."""
    rng = np.random.default_rng(2000 + 10 * P + KINDS.index(kind))
    pm = _values(rng, kind, (P, 16), signed=False).sort(0).values
    pm[:, 0] = torch.tensor([0.0] + [BIG] * (P - 1))
    pen = _values(rng, kind, (P, 16), signed=False)
    zero = torch.zeros_like(pen)
    _same(sorted_fork(pm, pen), fork2(pm, zero, pen), _top_k(pm, zero, pen))
    # a fork's output is sorted again: the next round may take the form
    nxt = fork2(pm, zero, pen)[0]
    _same(sorted_fork(nxt, pen), fork2(nxt, zero, pen))


def test_sorted_fork_is_wrong_on_unsorted_metrics():
    """Why `pm_sorted` is false for K3's path-bound pm_in, after R0 and a
    frozen leaf, and for SPC's first round (after the parity fix): on
    metrics out of order the sorted form picks other survivors."""
    pm = torch.tensor([[3.0], [0.0], [1.0]])
    pen = torch.tensor([[0.5], [4.0], [4.0]])
    zero = torch.zeros_like(pen)
    want = fork2(pm, zero, pen)
    got = sorted_fork(pm, pen)
    assert not all(torch.equal(w, g) for w, g in zip(want, got))
    _same(table_fork(pm, zero, pen), want)
    # the same metrics sorted: both forms agree
    order = pm[:, 0].argsort()
    _same(sorted_fork(pm[order], pen[order]), fork2(pm[order], zero, pen[order]))


def _rule_chain(pm, vals, eta, spc, pm_sorted):
    """The body's R1/SPC chain (rounds of `fork2(pm, 0, pen)` with the
    penalty gathered through the node map) where round r takes the
    sorted form iff r > 0 or (pm_sorted and not SPC); and the same rounds
    all through `fork2`. Returns both (pm, node map, eta)."""
    P = pm.shape[0]
    first = 1 if spc else 0
    rounds = min(P, vals.shape[0] - 1) if spc else min(P - 1, vals.shape[0])
    out = []
    for use_rule in (True, False):
        nm = torch.arange(P)[:, None].expand_as(pm).clone()
        e, p = eta.clone(), pm + eta.float() * vals[0] if spc else pm.clone()
        for r in range(rounds):
            pen = vals[r + first].gather(0, nm)
            if spc:
                pen = pen + (1.0 - 2.0 * e.float()) * vals[0].gather(0, nm)
            if use_rule and (r > 0 or (pm_sorted and not spc)):
                p, perm, bit = sorted_fork(p, pen)
            else:
                p, perm, bit = fork2(p, torch.zeros_like(pen), pen)
            nm, e = nm.gather(0, perm), e.gather(0, perm) ^ bit.long()
        out.append((p, nm, e))
    return out


@pytest.mark.parametrize("spc", [False, True])
@pytest.mark.parametrize("P", (9, 32))
def test_pm_sorted_rule_keeps_the_chain(P, spc):
    """A node's chain under the rule equals the chain of `fork2` rounds:
    on sorted metrics (R1's round 0 sorted) and on path-bound, unsorted
    ones (round 0 general), with SPC's parity fix before round 0."""
    rng = np.random.default_rng(3000 + P + spc)
    n = 16
    vals = _values(rng, "integer", (n + 1, P, 8), signed=False).sort(0).values
    eta = torch.as_tensor(rng.integers(0, 2, (P, 8)))
    for pm, ordered in ((_values(rng, "integer", (P, 8), signed=False).sort(0).values, True),
                        (_values(rng, "integer", (P, 8), signed=False), False)):
        got, want = _rule_chain(pm, vals, eta, spc, ordered)
        _same(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", C32_SIZES)
def test_rank_select_at_capacity32(P, kind):
    """The one-pass selection at 8 < P <= 32 (n_min up to 33) equals the
    rounds of `extract_mins` at n = 2 .. 512."""
    rng = np.random.default_rng(4000 + 10 * P + KINDS.index(kind))
    for n in C32_BLOCKS:
        absl = _values(rng, kind, (P, n, 2 if n > 64 else 16)).abs()
        counts = {min(P - 1, n), min(P, n - 1) + 1}
        for count in sorted(counts):
            wv, wp = extract_mins(absl, count)
            gv, gp = rank_select(absl, count)
            for r in range(count):
                assert torch.equal(wp[r], gp[r]), (n, count, r)
                assert torch.equal(wv[r], gv[r]), (n, count, r)


def test_capacity32_layout_keeps_two_blocks_an_sm():
    """`Small<32>` with its fork table and the dynamic state of K3 on every
    mixed_scl32 child at L=32, and of K1, K2, K4, K5 on the L=32 specs of
    kernel_times and the golden records, fit 2 blocks an SM."""
    from polar_tpu_torch.ops.program import build_program, subtree_items, subtree_spec
    from polar_tpu_torch.sim.golden import CRC8, jittered_spec

    def fits(spec, kernel):
        dyn = cuda_scl.general_smem_bytes(spec, 32, kernel)
        block = dyn + cuda_scl.SMALL32_STATIC_BYTES + RESERVED_PER_BLOCK
        assert SMALL32_MIN_BLOCKS * block <= SMEM_PER_SM, (spec.factors, kernel, dyn)

    spec = presets.get_preset("mixed_scl32").spec
    subs = [it for it in subtree_items(build_program(spec, scl=True), spec)
            if it[0] == "sub"]
    assert len(subs) == 13
    for _, _, fr in subs:
        fits(subtree_spec(spec, fr), "scl_subtree")
    for factors, K in (((2,) * 7, 56), ((16, 2, 2), 20), ((2, 16, 2), 14)):
        for kernel in ("scl_decode", "scl_decode_traj", "scl_mc_traj", "scl_mc_counters"):
            fits(jittered_spec(factors, K, CRC8), kernel)
    # Small<32> is 10,368 B without its table: 16 float4 candidates, 32
    # survivor metrics, 32 parity words, 32 + 32 bytes of slots and rstar
    assert cuda_scl.SMALL32_STATIC_BYTES == 10368 + 16 * 16 + 4 * 32 * 2 + 2 * 32
