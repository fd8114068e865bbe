"""Batched SC / CRC-aided SC-list decoder, plain PyTorch: the benchmark's
reference decoder.

A frozen copy of polar_tpu_torch/ops/scl.py's plain version (the op
program in PyTorch tensor ops) for Arikan, eBCH (4x4 .. 16x16) and mixed
kernels: each stage's DOWN and UP go through kernel_proc.py
StageProcessor (f/g for 2x2, the syndrome trellis or tail table for
larger kernels). In its default configuration (fast node program,
Fast-SSCL R1/SPC forks, float32, min-sum f, |llr| path metric, no genie)
it computes what the program's CUDA decode kernels compute, bit for bit;
with llr_dtype=torch.bfloat16 it is the benchmark's lower-precision
control.

A batch of B codewords x P list paths decodes in lockstep over the
host-built fast-SSCL op program (ops/program.py). Tal-Vardy lazy copies
are per-stage path->slot maps (rlam / rdec, [P, B] int64): a fork permutes
the maps only; bulk LLR / decision buffers are never copied, reads gather
through the maps and every write lands at identity slots and resets its
map. A node's input LLR buffer is always written by the DOWN op right
before it, so nodes read it at identity slots.

Conventions the CUDA kernel repeats exactly:
- 2P -> P forks keep the P smallest candidate metrics, candidates ordered
  bit-major (c = bit * P + path), ties to the lower candidate index
  (`lax.top_k` on negated metrics in the JAX package): a stable sort.
- Least-reliable positions: ties to the lowest index.
- Node metric sums (R0 / REP) use one fixed pairwise tree, x[:h] + x[h:],
  so the kernel and this version agree bit for bit, path metrics too.
- The best path is the first-index argmin of pm + 1e30 * (CRC fails).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.ref.polar import CodeSpec
from portbench.ref.kernel_proc import StageProcessor
from portbench.ref.program import build_program, staged_inverse_kernels
from portbench.ref.schedule import build_schedule

BIG = 1e30   # metric penalty of a CRC failure; initial metric of paths 1..P-1
MAX_LIST = 32
KERNEL_SIZES = (2, 4, 8, 16)
F_MODES = ("minsum", "exact")
PM_MODES = ("abs", "smooth")
# the knobs of the JAX package's build_scl_decoder and their defaults
KNOB_DEFAULTS = {"genie": False, "fast": True, "fast_r1_scl": True,
                 "llr_dtype": torch.float32, "unroll": True,
                 "f_mode": "minsum", "pm_mode": "abs"}


class DecodeResult(NamedTuple):
    u: torch.Tensor        # [B, N] int8 best path's u decisions
    payload: torch.Tensor  # [B, K + n_crc] int8 unfrozen slots of u
    crc_ok: torch.Tensor   # [B] bool: best path passed CRC (True if no CRC)
    pm: torch.Tensor       # [B] float32 best path metric


def check_supported(spec: CodeSpec, list_size: int) -> None:
    """Raise for what the port does not decode yet."""
    if any(f not in KERNEL_SIZES for f in spec.factors):
        raise NotImplementedError(
            f"factors {spec.factors}: kernel sizes other than "
            f"{KERNEL_SIZES} (build_bch_kernel's) are not ported")
    if not 1 <= int(list_size) <= MAX_LIST:
        raise ValueError(f"list_size {list_size} outside 1..{MAX_LIST}")


def check_knobs(list_size: int, genie: bool, f_mode: str, pm_mode: str) -> None:
    """The JAX package's refusals of knob values, with its messages."""
    if genie and int(list_size) != 1:
        raise ValueError("genie mode requires list_size=1")
    if pm_mode not in PM_MODES:
        raise ValueError(f"unknown pm_mode {pm_mode!r}")
    if f_mode not in F_MODES:
        raise ValueError(f"unknown f_mode {f_mode!r}")


def pen_abs(lam: torch.Tensor) -> torch.Tensor:
    """Path-metric penalty of deciding the bit u with (1 - 2u) * llr = lam,
    pm_mode="abs": max(-lam, 0), in float32."""
    return torch.clamp_min(-lam.to(torch.float32), 0.0)


def pen_smooth(lam: torch.Tensor) -> torch.Tensor:
    """The same penalty, pm_mode="smooth": log(1 + e^-lam) in float32, as
    the JAX package computes it (jax.nn.softplus(-lam) = logaddexp(-lam,
    0) = max(x, 0) + log1p(exp(-|x|)) at x = -lam).
    torch.nn.functional.softplus is another expression (log1p(exp(x)) up
    to its threshold, x above it) and rounds differently."""
    x = -lam.to(torch.float32)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 of [P, n, B] (n a power of two) as the fixed pairwise
    tree x[:, :h] + x[:, h:], repeated; the CUDA kernel uses the same."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def pgather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather the path axis (dim 0) of x [P, ..., B] by idx [P', B]:
    out[p, ..., b] = x[idx[p, b], ..., b]."""
    shape = (idx.shape[0],) + tuple(x.shape[1:])
    view = idx.reshape((idx.shape[0],) + (1,) * (x.ndim - 2) + (idx.shape[1],))
    return torch.gather(x, 0, view.expand(shape))


def fork2(pm: torch.Tensor, pen0: torch.Tensor, pen1: torch.Tensor):
    """Bit-major 2-way fork + top-P: returns (pm', perm, bit), [P, B] each."""
    P = pm.shape[0]
    cand = torch.cat([pm + pen0, pm + pen1], dim=0)            # [2P, B]
    vals, c = torch.sort(cand, dim=0, stable=True)
    c = c[:P]
    return vals[:P], c % P, (c // P).to(torch.int8)


def apply_inverse(x: torch.Tensor, inverses=None) -> torch.Tensor:
    """u = x (K_{d+1} (x) ... (x) K_m)^-1 for blocks [P, n, B] int8.

    inverses: the GF(2) inverses of the kernels below, outermost first
    (ops/program.staged_inverse_kernels); None for Arikan blocks, whose F
    is self-inverse: butterfly XORs."""
    p_, n, b = x.shape
    if inverses is None:
        h = n // 2
        while h >= 1:
            t = x.reshape(p_, n // (2 * h), 2, h, b)
            x = torch.stack([t[:, :, 0] ^ t[:, :, 1], t[:, :, 1]], dim=2)
            x = x.reshape(p_, n, b)
            h //= 2
        return x
    pre = 1
    for ki in inverses:
        lf = ki.shape[0]
        t = x.reshape(p_, pre, lf, n // (pre * lf), b)
        cols = []
        for k in range(lf):
            acc = torch.zeros_like(t[:, :, 0])
            for j in range(lf):
                if ki[j, k]:
                    acc = acc ^ t[:, :, j]
            cols.append(acc)
        x = torch.stack(cols, dim=2).reshape(p_, n, b)
        pre *= lf
    return x


def extract_mins(absl: torch.Tensor, count: int):
    """count smallest values + positions along dim 1 of [P, n, B], in
    ascending order, ties to the lowest index (a chosen position counts as
    BIG afterwards). Returns lists of [P, B] float32 / int64."""
    vals, poss = [], []
    work = absl.clone()
    for _ in range(count):
        v, a = torch.min(work, dim=1)
        vals.append(v)
        poss.append(a)
        work.scatter_(1, a[:, None, :], BIG)
    return vals, poss


def defer_flips(perms, flips):
    """Map per-round flip bits to final path indexing: round r's flips are
    recorded in post-round-r indexing, and rounds r+1.. permute the paths,
    so flips_fin[r] = flip_r[perm_{r+1}[... perm_{q-1}[p]]]."""
    q = len(perms)
    out = [None] * q
    s = None
    for r in range(q - 1, -1, -1):
        out[r] = flips[r] if s is None else torch.gather(flips[r], 0, s)
        s = perms[r] if s is None else torch.gather(perms[r], 0, s)
    return out


def scl_epilogue(spec: CodeSpec, P: int, entries, traj_bit, pm) -> DecodeResult:
    """Genealogy backtrack + CRC path selection.

    entries: per trajectory op (t0, n, perm [P, B]) in leaf order with
    disjoint spans covering [0, N); traj_bit [N, P, B] holds each op's bits
    in post-op path indexing; pm [P, B] final path metrics.
    """
    pieces = [None] * len(entries)
    s = None          # exclusive suffix composition perm_{q+1} o ... o perm_{Q-1}
    for q in range(len(entries) - 1, -1, -1):
        t0, n, perm = entries[q]
        bits = traj_bit[t0:t0 + n]
        pieces[q] = bits if s is None else torch.gather(
            bits, 1, s[None].expand(bits.shape))
        s = perm if s is None else torch.gather(perm, 0, s)
    u_all = torch.cat(pieces, dim=0)                               # [N, P, B]
    pos = torch.as_tensor(spec.info_positions, device=u_all.device)
    return finalize(spec, P, u_all, u_all[pos], pm)


def finalize(spec: CodeSpec, P: int, u_all, payload_all, pm) -> DecodeResult:
    """CRC check per path, best-path selection, [B]-major outputs. The CRC
    product runs in float64 (exact, and never TF32 on the card)."""
    bsz = pm.shape[-1]
    dev = pm.device
    if spec.crc is not None:
        k = spec.K
        g = torch.as_tensor(spec.crc.generator_matrix(k), device=dev,
                            dtype=torch.float64)
        off = torch.as_tensor(spec.crc.offset_bits(k), device=dev,
                              dtype=torch.float64)
        bits = torch.remainder(
            torch.einsum("kpb,kw->wpb", payload_all[:k].to(torch.float64), g)
            + off[:, None, None], 2.0)
        ok = torch.all(bits.to(torch.int8) == payload_all[k:], dim=0)
        score = pm + BIG * (1.0 - ok.to(torch.float32))
    else:
        ok = torch.ones((P, bsz), dtype=torch.bool, device=dev)
        score = pm
    best = torch.argmin(score, dim=0)                              # [B]
    u_best = torch.gather(u_all, 1, best[None, None].expand(
        u_all.shape[0], 1, bsz))[:, 0]
    payload = torch.gather(payload_all, 1, best[None, None].expand(
        payload_all.shape[0], 1, bsz))[:, 0]
    return DecodeResult(u=u_best.T.contiguous(), payload=payload.T.contiguous(),
                        crc_ok=ok.gather(0, best[None])[0],
                        pm=pm.gather(0, best[None])[0])


class _State:
    """Decoder state of one batch: buffers, lazy maps, metrics, genealogy.

    From channel LLRs llrs [B, N] (the input is the same on every path),
    or, for a depth-1 child decoded on its own (`build_plain_subtree`),
    from a path-bound input block lam1 [P, N, B] and the parent's metrics
    pm [P, B]: path p reads row netmap[p] of it, netmap composing every
    fork since the start. The channel LLRs and every carried LLR buffer
    are stored in `llr_dtype` (the JAX package's two choke points: lam0 and
    the end of each DOWN)."""

    def __init__(self, spec: CodeSpec, P: int, llrs: torch.Tensor,
                 pm: torch.Tensor | None = None,
                 llr_dtype: torch.dtype = torch.float32):
        bsz = llrs.shape[-1] if pm is not None else llrs.shape[0]
        dev = llrs.device
        m = len(spec.factors)
        ns = spec.block_sizes
        self.iota = torch.arange(P, device=dev)[:, None].expand(P, bsz)
        if pm is None:
            self.lam0 = llrs.T.to(llr_dtype)                       # [N, B]
            self.netmap = None
            self.pm = torch.full((P, bsz), BIG, device=dev)
            self.pm[0] = 0.0
        else:
            self.lam0 = llrs.to(torch.float32)                     # [P, N, B]
            self.netmap = self.iota
            self.pm = pm
        # index s-1 holds stage s (s = 1..m)
        self.lam = [torch.zeros((P, ns[s], bsz), dtype=llr_dtype, device=dev)
                    for s in range(1, m + 1)]
        self.dec = [torch.zeros((spec.factors[s - 1], P, ns[s], bsz),
                                dtype=torch.int8, device=dev)
                    for s in range(1, m + 1)]
        self.rlam = [self.iota for _ in range(m)]
        self.rdec = [[self.iota] * f for f in spec.factors]
        self.traj_bit = torch.zeros((spec.N, P, bsz), dtype=torch.int8,
                                    device=dev)
        self.traj = []

    def apply_perm(self, perm: torch.Tensor) -> None:
        """Permute every path->slot map by a survival permutation [P, B]."""
        self.rlam = [r.gather(0, perm) for r in self.rlam]
        self.rdec = [[r.gather(0, perm) for r in rs] for rs in self.rdec]
        if self.netmap is not None:
            self.netmap = self.netmap.gather(0, perm)

    def input_view(self, l: int, n: int) -> torch.Tensor:
        """The stage-1 DOWN's parent block as [P or 1, l, n, B]."""
        if self.netmap is None:
            return self.lam0.reshape(1, l, n, -1)
        return pgather(self.lam0, self.netmap).reshape(-1, l, n,
                                                       self.lam0.shape[-1])

    def write_dec(self, d: int, child: int, block: torch.Tensor) -> None:
        """Record a depth-d node's hard output block [P, n_d, B] as child
        `child` of its parent's kernel."""
        self.dec[d - 1][child] = block
        self.rdec[d - 1][child] = self.iota

    def dec_children(self, s: int, count: int) -> torch.Tensor:
        """Children 0..count-1 of stage s, path-correct, zeros for the
        rest: [l_s, P, n_s, B] int8."""
        rows = [self.dec_child(s, j) for j in range(count)]
        zero = torch.zeros_like(self.dec[s - 1][0])
        return torch.stack(rows + [zero] * (self.dec[s - 1].shape[0] - count))

    def dec_child(self, s: int, j: int) -> torch.Tensor:
        return pgather(self.dec[s - 1][j], self.rdec[s - 1][j])

    def write_traj(self, t0: int, perm: torch.Tensor, bits: torch.Tensor) -> None:
        """bits [P, n, B] in post-op path indexing; perm the op's survival
        permutation."""
        n = bits.shape[1]
        self.traj_bit[t0:t0 + n] = bits.permute(1, 0, 2)
        self.traj.append((t0, n, perm))


def trajectory_spans(spec: CodeSpec, list_size: int) -> list[tuple[int, int]]:
    """(t0, n) of each trajectory op (node op) of the decode program, in
    program order: the spans of traj_bit that traj_perm[q] belongs to."""
    ns = spec.block_sizes
    return [(op.t0, ns[op.level])
            for op in build_program(spec, scl=(int(list_size) > 1)).ops
            if op.kind not in ("DOWN_FRESH", "DOWN_DYN", "UP")]


class _Program(NamedTuple):
    """The op program of one (spec, list size) as PyTorch steps."""
    program: object           # ops/program.Program
    steps: list               # per op: (handler, level, t0)
    procs: list               # per stage: StageProcessor
    digits: np.ndarray        # leaf -> kernel input index per stage


def _build_program_steps(spec: CodeSpec, P: int,
                         genie: bool = False, fast: bool = True,
                         fast_r1_scl: bool = True,
                         llr_dtype: torch.dtype = torch.float32,
                         f_mode: str = "minsum",
                         pm_mode: str = "abs") -> _Program:
    """Each op of the program as a handler fn(state, level, t0) on a
    `_State`: the fast-SSCL program, or with the knobs (the JAX package's
    build_scl_decoder's) the leaf-sequential one."""
    check_knobs(P, genie, f_mode, pm_mode)
    if f_mode != "minsum" or pm_mode != "abs":
        fast = False  # node shortcuts assume min-sum/abs telescoping
    m = len(spec.factors)
    ns = spec.block_sizes
    factors = spec.factors
    digits = build_schedule(spec).digits
    frozen = spec.frozen.astype(bool)
    program = build_program(spec, scl=(P > 1), classify=fast,
                            fast_r1_scl=fast_r1_scl, genie=genie)
    procs = [StageProcessor(k, f_mode=f_mode) for k in spec.kernels]
    pen = pen_smooth if pm_mode == "smooth" else pen_abs
    inv_kernels = staged_inverse_kernels(spec)
    # per depth d: the inverses of the kernels below, None if all Arikan
    inverses = [None if all(f == 2 for f in factors[d:]) else
                [k.astype(np.uint8) for k in inv_kernels[d:]]
                for d in range(m + 1)]

    def down(st: _State, s: int, t0: int, fresh: bool) -> None:
        """Input i's LLRs of stage s (f / g for the 2x2 kernel)."""
        l, n = factors[s - 1], ns[s]
        if s == 1:
            # the channel view at P = 1 (the result broadcasts over paths),
            # or a child's path-bound input
            view = st.input_view(l, n)
        else:
            view = pgather(st.lam[s - 2], st.rlam[s - 2]).reshape(P, l, n, -1)
        if fresh:
            llr = procs[s - 1].fresh_llr(view)
        else:
            i = int(digits[t0, s - 1])
            llr = procs[s - 1].static_llr(i, view, st.dec_children(s, i))
        st.lam[s - 1] = llr.expand(P, n, llr.shape[-1]).to(llr_dtype).contiguous()
        st.rlam[s - 1] = st.iota

    def up(st: _State, s: int, t0: int) -> None:
        x = procs[s - 1].reencode(st.dec_children(s, factors[s - 1]))
        st.write_dec(s - 1, int(digits[t0, s - 2]),
                     x.reshape(P, ns[s - 1], x.shape[-1]))

    def node_sum(lam: torch.Tensor, pens: torch.Tensor) -> torch.Tensor:
        """A node's metric sum, rounded to the LLR dtype as the JAX
        package's jnp.sum over lam rounds it (a no-op in float32)."""
        return tree_sum(pens).to(lam.dtype).to(torch.float32)

    def r0(st: _State, d: int, t0: int) -> None:
        lam = st.lam[d - 1]
        st.pm = st.pm + node_sum(lam, pen(lam))
        zeros = torch.zeros_like(lam, dtype=torch.int8)
        st.write_traj(t0, st.iota, zeros)
        st.write_dec(d, int(digits[t0, d - 1]), zeros)

    def rep(st: _State, d: int, t0: int) -> None:
        lam = st.lam[d - 1]
        n = ns[d]
        s0 = node_sum(lam, pen(lam))
        s1 = node_sum(lam, pen(-lam))
        if P == 1:
            bit = (s1 < s0).to(torch.int8)
            pm = st.pm + torch.where(bit == 1, s1, s0)
            perm = st.iota
        else:
            pm, perm, bit = fork2(st.pm, s0, s1)
            st.apply_perm(perm)
        st.pm = pm
        ubits = torch.zeros_like(lam, dtype=torch.int8)
        ubits[:, n - 1] = bit
        st.write_traj(t0, perm, ubits)
        st.write_dec(d, int(digits[t0, d - 1]),
                     bit[:, None, :].expand(lam.shape).contiguous())

    def flip_at(xhat: torch.Tensor, pos: torch.Tensor, flip: torch.Tensor):
        """xhat[p, pos[p], b] ^= flip[p, b]."""
        cur = xhat.gather(1, pos[:, None, :])
        return xhat.scatter(1, pos[:, None, :], cur ^ flip[:, None, :])

    def finish_node(st: _State, d: int, t0: int, node_map, pm, xhat) -> None:
        st.apply_perm(node_map)
        st.pm = pm
        st.write_traj(t0, node_map, apply_inverse(xhat, inverses[d]))
        st.write_dec(d, int(digits[t0, d - 1]), xhat)

    def r1(st: _State, d: int, t0: int) -> None:
        lam = st.lam[d - 1]
        n = ns[d]
        hd = (lam < 0).to(torch.int8)
        if P == 1:
            st.write_traj(t0, st.iota, apply_inverse(hd, inverses[d]))
            st.write_dec(d, int(digits[t0, d - 1]), hd)
            return
        # Fast-SSCL: q keep/flip forks on the least reliable positions;
        # flips are recorded per round and mapped to final indexing after
        q = min(P - 1, n)
        vals, poss = extract_mins(lam.abs().to(torch.float32), q)
        node_map = st.iota
        pm = st.pm
        perms, flips = [], []
        for r in range(q):
            v = vals[r].gather(0, node_map)
            pm, perm, flip = fork2(pm, torch.zeros_like(v), v)
            node_map = node_map.gather(0, perm)
            perms.append(perm)
            flips.append(flip)
        flips_fin = defer_flips(perms, flips)
        xhat = pgather(hd, node_map)
        for r in range(q):
            xhat = flip_at(xhat, poss[r].gather(0, node_map), flips_fin[r])
        finish_node(st, d, t0, node_map, pm, xhat)

    def spc(st: _State, d: int, t0: int) -> None:
        """Single parity check node. SC: hd + flip the least-reliable
        position on parity failure. SCL: mandatory parity fix, then
        min(P, n-1) keep/flip pair-forks with a per-path parity state eta
        (is the least-reliable bit currently flipped)."""
        lam = st.lam[d - 1]
        n = ns[d]
        hd = (lam < 0).to(torch.int8)
        par = (hd.sum(dim=1, dtype=torch.int32) % 2).to(torch.int8)   # [P, B]
        absl = lam.abs().to(torch.float32)
        if P == 1:
            vals, poss = extract_mins(absl, 1)
            xhat = flip_at(hd, poss[0], par)
            st.pm = st.pm + vals[0] * par.to(torch.float32)
            st.write_traj(t0, st.iota, apply_inverse(xhat, inverses[d]))
            st.write_dec(d, int(digits[t0, d - 1]), xhat)
            return
        q = min(P, n - 1)
        vals, poss = extract_mins(absl, q + 1)
        v0 = vals[0]
        pm = st.pm + par.to(torch.float32) * v0
        eta = par
        node_map = st.iota
        perms, flips = [], []
        for r in range(1, q + 1):
            v_r = vals[r].gather(0, node_map)
            v0_g = v0.gather(0, node_map)
            pen = v_r + (1.0 - 2.0 * eta.to(torch.float32)) * v0_g
            pm, perm, flip = fork2(pm, torch.zeros_like(pen), pen)
            node_map = node_map.gather(0, perm)
            eta = eta.gather(0, perm) ^ flip
            perms.append(perm)
            flips.append(flip)
        flips_fin = defer_flips(perms, flips)
        xhat = pgather(hd, node_map)
        xhat = flip_at(xhat, poss[0].gather(0, node_map), eta)
        for r in range(1, q + 1):
            xhat = flip_at(xhat, poss[r].gather(0, node_map), flips_fin[r - 1])
        finish_node(st, d, t0, node_map, pm, xhat)

    def leaf(st: _State, d: int, t: int) -> None:
        lam = st.lam[m - 1][:, 0]
        pen0, pen1 = pen(lam), pen(-lam)
        perm = st.iota
        if genie or frozen[t]:
            bit = torch.zeros_like(lam, dtype=torch.int8)
            st.pm = st.pm + pen0
        elif P == 1:
            bit = (lam < 0).to(torch.int8)
            st.pm = st.pm + torch.where(bit == 1, pen1, pen0)
        else:
            st.pm, perm, bit = fork2(st.pm, pen0, pen1)
            st.apply_perm(perm)
        # genie: every leaf decides the all-zero codeword's bit 0, and the
        # trajectory records the leaf's error, lam < 0
        traj = (lam < 0).to(torch.int8) if genie else bit
        st.write_traj(t, perm, traj[:, None, :])
        st.write_dec(m, int(digits[t, m - 1]), bit[:, None, :])

    handlers = {
        "DOWN_FRESH": lambda st, s, t0: down(st, s, t0, True),
        "DOWN_DYN": lambda st, s, t0: down(st, s, t0, False),
        "UP": up, "R0": r0, "REP": rep, "R1": r1, "SPC": spc, "LEAF": leaf,
    }
    steps = [(handlers[op.kind], op.level, op.t0) for op in program.ops]
    return _Program(program, steps, procs, digits)


def build_plain_scl_decoder(spec: CodeSpec, list_size: int,
                            llr_dtype: torch.dtype = torch.float32):
    """decode(llrs [B, N] float32 tensor) -> DecodeResult, in plain PyTorch
    on the tensor's own device: the fast-SSCL op program with the
    program's default knobs. With llr_dtype=torch.bfloat16 the channel
    LLRs and the carried LLR buffers are bfloat16, penalties and path
    metrics float32 (the lower-precision control)."""
    check_supported(spec, list_size)
    P = int(list_size)
    prog = _build_program_steps(spec, P, llr_dtype=llr_dtype)

    def decode(llrs: torch.Tensor) -> DecodeResult:
        if llrs.ndim != 2 or llrs.shape[1] != spec.N:
            raise ValueError(f"llrs must be [B, {spec.N}], got "
                             f"{tuple(llrs.shape)}")
        st = _State(spec, P, llrs, llr_dtype=llr_dtype)
        for fn, level, t0 in prog.steps:
            fn(st, level, t0)
        return scl_epilogue(spec, P, st.traj, st.traj_bit, st.pm)

    return decode
