"""The Arikan capacity-8 body's second Hopper design (csrc/scl_decode.cu
`fast_body`: K1, K2, K4, K5 of Arikan specs at L <= 8), on the CPU: its
layout and threads rule, parts of the launch plan (ops/cuda_scl.py
`fast_smem_bytes`, `fast_threads`, `fast_blocks_per_sm`, `stage1_view`),
and plain models of the three rules the body adopted, held against the
plain decoder's own values (ops/scl.py) and JAX's `lax.top_k`:

- stage 1 is read through the channel row: a stage-2 DOWN of path p
  recomputes stage 1's row from the decision row of path map 1 *now*,
  where the stored layout read row map0[p], made from decision row
  map1[map0[p]] at the stage-1 DOWN_DYN; the lazy maps of a whole ca_scl
  decode, replayed from the plain decoder's survival permutations, keep
  the two equal;
- the fork in registers (`fork_reg`): each lane ranks its candidate by
  shuffles, survivor r comes from the lane whose rank is r (a ballot);
- the selection of nodes of n >= 64 by extraction (`extract_path`): a
  warp a path, rounds of a warp minimum by (|v|, j) over a butterfly.

The kernels themselves run on the card (tests/test_torch_cuda.py, marker
`gpu`).
"""
import numpy as np
import pytest
import torch

from polar_tpu_torch.models import presets
from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops import cuda_scl
from polar_tpu_torch.ops.program import build_program
from polar_tpu_torch.ops.scl import BIG, build_plain_scl_decoder, extract_mins, fork2
from tests.test_torch_select import (KINDS, LIST_SIZES, _top_k, _values, rank_fork,
                                     rank_select)

KERNELS = ("scl_decode", "scl_decode_traj", "scl_mc_traj", "scl_mc_counters")
MC = ("scl_mc_traj", "scl_mc_counters")
SIZES = (16, 64, 1024, 2048, 4096)
SMEM_PER_SM = 228 * 1024       # an H100 SM's shared memory
RESERVED_PER_BLOCK = 1024      # what the runtime keeps of it a block
SMEM_PER_BLOCK = 232448        # the most a block may use
REGISTERS_PER_SM = 65536


def _spec(N: int) -> CodeSpec:
    """ca_scl at N = 1024, else an Arikan code with a jittered frozen set
    (no half of it a special node, so stage 1 goes through the row)."""
    if N == 1024:
        return presets.ca_scl().spec
    r = np.random.default_rng(N)
    mask = np.ones(N, np.uint8)
    mask[np.argsort(r.random(N) + np.linspace(0, 1, N))[-(N // 2):]] = 0
    return CodeSpec(N=N, K=N // 2, factors=(2,) * int(np.log2(N)),
                    frozen_mask=tuple(int(v) for v in mask))


# ---- the layout and the threads rule ----

def test_layout_and_threads_at_the_presets():
    """ca_scl (L=8): K5/K4 25,176 B, 128 threads, 8 blocks an SM; K1/K2
    20,952 B, 64 threads, 10 blocks (the first design: 42,456 and 37,336
    B, 128 threads, 5 blocks); arikan_sc (L=1): 64 threads, 16 blocks."""
    ca = presets.ca_scl().spec
    want = {"scl_mc_counters": (25176, 128, 8), "scl_mc_traj": (25176, 128, 8),
            "scl_decode": (20952, 64, 10), "scl_decode_traj": (20952, 64, 10)}
    for kernel, (dyn, T, blocks) in want.items():
        assert cuda_scl.stage1_view(ca, 8)
        assert cuda_scl.fast_smem_bytes(ca, 8, kernel) == dyn
        assert cuda_scl.fast_threads(ca, 8, kernel) == T
        assert cuda_scl.fast_blocks_per_sm(ca, 8, kernel) == blocks
    sc = presets.get_preset("arikan_sc").spec
    for kernel in KERNELS:
        assert cuda_scl.fast_threads(sc, 1, kernel) == 64
        assert cuda_scl.fast_blocks_per_sm(sc, 1, kernel) == 16
    # no fork table (cand, spm, src) and one flip mask a path for the
    # perms, flips and flipfin records: 1,232 B before
    assert cuda_scl.FAST_STATIC_BYTES == 944


@pytest.mark.parametrize("N", SIZES)
def test_layout_mirror_at_every_list_size(N):
    """At N = 16 .. 4096 and L = 1..8: without stage 1 the LLR buffers
    shrink by P*N/2 floats (the Monte-Carlo kernels keep 2N bytes of
    prologue scratch), u_true takes ceil(N/32) words; the state fits a
    block; the threads rule gives 128 threads exactly where shared memory
    holds no more 128-thread blocks than the registers allow; and the
    blocks an SM are those of the layout (shared memory given a block in
    128-byte units)."""
    spec = _spec(N)
    assert cuda_scl.stage1_view(spec, 1) and cuda_scl.stage1_view(spec, 8)
    for L in range(1, 9):
        P = L
        for kernel in KERNELS:
            dyn = cuda_scl.fast_smem_bytes(spec, L, kernel)
            stored = _stored_layout_bytes(spec, L, kernel)
            lam = 4 * P * (N - 1)
            saved = lam - (max(lam - 4 * P * (N // 2), 2 * N) if kernel in MC
                           else lam - 4 * P * (N // 2))
            ut = (N - 4 * -(-N // 32)) if kernel in MC else 0
            # the same layout otherwise, up to its 8- and 4-byte alignments
            assert abs(stored - dyn - saved - ut) < 8, (N, L, kernel)
            assert dyn % 4 == 0
            assert dyn + cuda_scl.FAST_STATIC_BYTES <= SMEM_PER_BLOCK
            block = dyn + cuda_scl.FAST_STATIC_BYTES + RESERVED_PER_BLOCK
            by_smem = SMEM_PER_SM // block
            T = cuda_scl.fast_threads(spec, L, kernel)
            assert T == (128 if by_smem * 128 * cuda_scl.FAST_REGISTERS <= REGISTERS_PER_SM
                         else 64), (N, L, kernel)
            blocks = cuda_scl.fast_blocks_per_sm(spec, L, kernel)
            unit = -(-(block - RESERVED_PER_BLOCK) // 128) * 128 + RESERVED_PER_BLOCK
            assert blocks == min(32, REGISTERS_PER_SM // cuda_scl.FAST_REGISTERS // T,
                                 SMEM_PER_SM // unit)
            # never fewer codewords an SM than the first design's layout
            old = SMEM_PER_SM // (stored + 1232 + RESERVED_PER_BLOCK)   # then static
            assert blocks >= min(old, 65536 // 128 // 64), (N, L, kernel)


def _stored_layout_bytes(spec, L, kernel):
    """The first design's dynamic shared memory: stage 1 stored, u_true N
    bytes, no 4-byte alignment before it."""
    N, P, m = spec.N, L, len(spec.factors)
    Q = len(cuda_scl.trajectory_spans(spec, P))
    off = 4 * P * (N - 1) + (4 * N if kernel in MC else 0)
    off += sum(8 * -(-P * (N >> s) // 32) for s in range(1, m + 1))
    off += 4 * P * -(-N // 32)
    off = -(-off // 8) * 8
    return off + 24 * m + 2 * Q * P + (N if kernel in MC else 0)


def test_stage1_is_stored_where_a_node_reads_it():
    """A code whose first half is all frozen has an R0 node at depth 1,
    which reads stage 1 as a buffer: the body keeps it there."""
    for N in (16, 64):
        spec = CodeSpec(N=N, K=N // 2, factors=(2,) * int(np.log2(N)),
                        frozen_mask=tuple([1] * (N // 2) + [0] * (N // 2)))
        for L in (1, 4, 8):
            assert not cuda_scl.stage1_view(spec, L)
            assert (cuda_scl.fast_smem_bytes(spec, L, "scl_decode")
                    >= 4 * L * (N - 1))


# ---- the stage-1 view: the lazy maps of a whole decode ----

@pytest.mark.parametrize("L", [2, 5, 8])
def test_stage1_view_reads_the_stored_row(L):
    """Replay the body's lazy path maps over a ca_scl decode of 16 noisy
    frames with the plain decoder's survival permutations: at every
    stage-2 DOWN, the decision row the stored stage-1 row was made from,
    map1_then[map0_now[p]], equals map1_now[p], the row the view reads; and
    no op after the stage-1 DOWN_DYN writes stage 1's child-0 decisions."""
    spec = presets.ca_scl().spec
    m = len(spec.factors)
    rng = np.random.default_rng(L)
    llr = torch.as_tensor(2.0 + 2.0 * rng.standard_normal((16, spec.N)),
                          dtype=torch.float32)
    tables = cuda_scl.build_tables(spec, L)
    ops = tables["ops"]
    perm = build_plain_scl_decoder(spec, L, trajectory=True)(llr)[1]   # [Q, P, B]
    B = llr.shape[0]
    ident = np.tile(np.arange(L), (B, 1))
    maps = [ident.copy() for _ in range(3 * m)]      # [B, P] each
    then = None                                     # map 1 at the stage-1 DYN
    checked, q = 0, 0
    for o, (kind, lvl, t0, child) in enumerate(ops):
        if kind in (0, 1):                          # DOWN_FRESH, DOWN_DYN
            if lvl == 1 and kind == 1:
                then = maps[1].copy()
                after = [op for op in ops[o + 1:]
                         if (op[0] == 2 and op[1] == 2 and op[3] == 0)
                         or (op[0] >= 3 and op[1] == 1 and op[3] == 0)]
                assert not after
            if lvl == 2 and then is not None:
                made = np.take_along_axis(then, maps[0], 1)
                assert np.array_equal(made, maps[1])
                checked += 1
            maps[3 * (lvl - 1)] = ident.copy()
        elif kind == 2:                             # UP
            maps[3 * (lvl - 2) + 1 + child] = ident.copy()
        else:                                       # node ops
            reset = 3 * (lvl - 1) + 1 + child
            if kind != 3:                           # R0 only resets
                nm = perm[q].numpy().T              # [B, P]
                maps = [np.take_along_axis(mp, nm, 1) for mp in maps]
            maps[reset] = ident.copy()
            q += 1
    assert q == perm.shape[0]
    assert checked == 2          # ca_scl's two stage-2 DOWNs of the right half


# ---- the fork in registers ----

def reg_fork(pm, pen0, pen1):
    """`fork_reg` lane by lane: lane l < 2P holds candidate l (a = pm +
    pen0 for l < P, b = pm + pen1 of path l - P from a shuffle) and counts
    the candidates before it by (metric, c) over 2P shuffles; lane r takes
    the lowest lane of the ballot on rank == r."""
    P, B = pm.shape
    a, b = pm + pen0, pm + pen1
    lanes = torch.arange(32)
    v = torch.where((lanes < P)[:, None], a[lanes.clamp(max=P - 1)],
                    b[(lanes - P) % 32 % P])                       # [32, B]
    rank = torch.zeros((32, B), dtype=torch.int64)
    for k in range(P):
        rank += ((a[k] < v) | ((a[k] == v) & (k < lanes)[:, None])).long()
        rank += ((b[k] < v) | ((b[k] == v) & (P + k < lanes)[:, None])).long()
    npm = torch.zeros((P, B))
    src = torch.zeros((P, B), dtype=torch.int64)
    for r in range(P):
        ballot = ((lanes < 2 * P)[:, None] & (rank == r))            # [32, B]
        assert (ballot.sum(0) == 1).all()
        src[r] = ballot.int().argmax(0)
        npm[r] = v.gather(0, src[r][None])[0]
    return npm, src % P, (src >= P).to(torch.int8)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", LIST_SIZES)
def test_reg_fork_matches_fork2_rank_fork_and_top_k(P, kind):
    """Survivors, parents and bits equal `fork2`'s, the table fork's
    (`rank_fork`) and `lax.top_k`'s, ties and infinite metrics included."""
    rng = np.random.default_rng(500 + 10 * P + KINDS.index(kind))
    pm, pen0, pen1 = (_values(rng, kind, (P, 64), signed=False) for _ in range(3))
    got = reg_fork(pm, pen0, pen1)
    for want in (fork2(pm, pen0, pen1), rank_fork(pm, pen0, pen1),
                 _top_k(pm, pen0, pen1)):
        for w, g in zip(want, got):
            assert torch.equal(w, g)


@pytest.mark.parametrize("spc", [False, True])
@pytest.mark.parametrize("P", [2, 5, 8])
def test_register_chain_matches_fork2_rounds(P, spc):
    """An R1/SPC chain as the body runs it in registers: the penalty of
    survivor p read through its node map (a shuffle of the value path
    nm[p] holds), SPC's parity fix, the fork, nm and eta carried by
    shuffles; == the same rounds through `fork2`."""
    rng = np.random.default_rng(700 + P + spc)
    n = 16
    vals = _values(rng, "integer", (n + 1, P, 32), signed=False).sort(0).values
    eta0 = torch.as_tensor(rng.integers(0, 2, (P, 32)))
    pm0 = _values(rng, "integer", (P, 32), signed=False)
    first = 1 if spc else 0
    rounds = min(P, n - 1) if spc else min(P - 1, n)
    out = []
    for fork in (reg_fork, fork2):
        nm = torch.arange(P)[:, None].expand_as(pm0).clone()
        e = eta0.clone() if spc else torch.zeros_like(eta0)
        p = pm0 + e.float() * vals[0] if spc else pm0.clone()
        for r in range(rounds):
            pen = vals[r + first].gather(0, nm)
            if spc:
                pen = pen + (1.0 - 2.0 * e.float()) * vals[0].gather(0, nm)
            p, perm, bit = fork(p, p * 0.0, pen)
            nm, e = nm.gather(0, perm), e.gather(0, perm) ^ bit.long()
        out.append((p, nm, e))
    for w, g in zip(*out):
        assert torch.equal(w, g)


# ---- the selection of large nodes by extraction ----

def extract_select(absl, count: int):
    """`extract_path` lane by lane, then the chain head's `rstar` rule:
    lane l holds inputs j = l + 32 i; each round every lane takes its least
    untaken (|v|, j), a 5-step xor butterfly takes the least of the warp,
    its lane marks it taken."""
    P, n, B = absl.shape
    k = n // 32
    j = (torch.arange(32)[:, None] + 32 * torch.arange(k)[None])      # [32, k]
    a = absl[:, j.reshape(-1)].reshape(P, 32, k, B)
    taken = torch.zeros((P, 32, k, B), dtype=torch.bool)
    inf = torch.tensor(float("inf"))
    vals, poss = [], []
    for _ in range(count):
        bv = torch.full((P, 32, B), float("inf"))
        bj = torch.full((P, 32, B), 1 << 30, dtype=torch.int64)
        for i in range(k):
            av = torch.where(taken[:, :, i], inf, a[:, :, i])
            ji = j[:, i][None, :, None].expand_as(bj)
            take = ~taken[:, :, i] & ((av < bv) | ((av == bv) & (ji < bj)))
            bv, bj = torch.where(take, av, bv), torch.where(take, ji, bj)
        for off in (16, 8, 4, 2, 1):
            other = torch.arange(32) ^ off
            ov, oj = bv[:, other], bj[:, other]
            take = (ov < bv) | ((ov == bv) & (oj < bj))
            bv, bj = torch.where(take, ov, bv), torch.where(take, oj, bj)
        assert (bv == bv[:, :1]).all() and (bj == bj[:, :1]).all()
        win, jj = bv[:, 0], bj[:, 0]                                   # [P, B]
        for i in range(k):
            mark = (j[:, i][None, :, None] == jj[:, None]).expand_as(taken[:, :, i])
            taken[:, :, i] |= mark
        vals.append(win)
        poss.append(jj)
    rs = (absl < BIG).sum(1)
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", LIST_SIZES)
def test_extract_select_matches_rank_select_and_extract_mins(P, kind):
    """Positions and values of the n_min least reliable inputs at n = 64,
    128 and 1024 equal the one-pass rank's (`rank_select`) and the rounds of
    `extract_mins`, for R1's and SPC's n_min, incl. +-1e30, 3e30, +-inf."""
    rng = np.random.default_rng(900 + 10 * P + KINDS.index(kind))
    for n in (64, 128, 1024):
        absl = _values(rng, kind, (P, n, 4 if n < 1024 else 1)).abs()
        for count in sorted({min(P - 1, n), min(P, n - 1) + 1 if P > 1 else 1} - {0}):
            got = extract_select(absl, count)
            for want in (extract_mins(absl, count), rank_select(absl, count)):
                for r in range(count):
                    assert torch.equal(want[0][r], got[0][r]), (n, count, r)
                    assert torch.equal(want[1][r], got[1][r]), (n, count, r)


def test_ca_scl_selects_by_extraction_at_its_large_nodes():
    """ca_scl's op program has R1/SPC nodes of n = 64 and 128 (the
    extraction's) and none above 1024; the rest rank in one pass."""
    spec = presets.ca_scl().spec
    ns = {spec.block_sizes[op.level] for op in build_program(spec, scl=True).ops
          if op.kind in ("R1", "SPC")}
    assert {64, 128} <= ns and max(ns) <= 1024


# ---- the flips carried forward, the leader warp, the instances ----

@pytest.mark.parametrize("P", [2, 5, 8])
def test_forward_flip_mask_equals_the_walk_back(P):
    """A chain's flips on the line of final survivor p: the body carries
    mask |= bit << r forward through each round's parents (a shuffle by
    nperm); the first design recorded perms and flips a round and walked
    them back (`defer_flips`). Both give every (r, p)."""
    rng = np.random.default_rng(40 + P)
    for _ in range(200):
        rounds = int(rng.integers(1, 9))
        perms = rng.integers(0, P, (rounds, P))
        flips = rng.integers(0, 2, (rounds, P))
        mask = np.zeros(P, np.int64)
        for r in range(rounds):
            mask = mask[perms[r]] | (flips[r] << r)
        for p in range(P):
            s = p
            for r in range(rounds - 1, -1, -1):
                assert (mask[p] >> r) & 1 == flips[r, s]
                s = perms[r, s]


def test_leader_rule_spreads_the_sub_partitions():
    """The warp slots an H100 gives the Arikan body's blocks (kernel_times
    --slots): a 4-warp block k the slots 4k .. 4k + 3 with warp j on 4k +
    (j + k) % 4, a 2-warp block 2k, 2k + 1 with warp 0 on the even one.
    The rule keeps warp 0 at 4 warps and spreads the 2-warp blocks' leaders
    over sub-partitions 0, 2, 1, 3 where warp 0 would sit on 0 and 2 only;
    slots outside the pattern fall back to a warp of the block."""
    lead4 = [cuda_scl.leader_warp([4 * k + (j + k) % 4 for j in range(4)], 4)
             for k in range(16)]
    assert lead4 == [0] * 16
    subs2 = [(2 * k + cuda_scl.leader_warp([2 * k, 2 * k + 1], 2)) % 4 for k in range(16)]
    assert subs2 == [0, 2, 1, 3] * 4
    assert cuda_scl.leader_warp([5], 1) == 0
    assert cuda_scl.leader_warp([9, 13, 17, 21], 4) in range(4)


def test_rule_reaches_the_built_instances():
    """The source builds the Arikan body at 64 and 128 threads a codeword
    (`FAST_KERNELS`); the threads rule sends ca_scl's K5 and K4 to 128 and
    its K1, K2 and arikan_sc to 64."""
    import pathlib
    import re
    src = (pathlib.Path(__file__).resolve().parents[1] / "polar_tpu_torch" / "csrc"
           / "scl_decode.cu").read_text()
    assert re.findall(r"^FAST_KERNELS\((\d+)\)$", src, re.M) == ["64", "128"]
    seen = {cuda_scl.fast_threads(_spec(N), L, k) for N in SIZES
            for L in range(1, 9) for k in KERNELS}
    assert seen == {64, 128}
