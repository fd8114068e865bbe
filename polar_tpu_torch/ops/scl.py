"""Batched SC / CRC-aided SC-list decoder, plain PyTorch version.

Counterpart of polar_tpu/ops/scl.py, for Arikan, eBCH (4x4 .. 16x16) and
mixed kernels: each stage's DOWN and UP go through ops/kernel_proc.py
StageProcessor (f/g for 2x2, the syndrome trellis or tail table for
larger kernels). In its default configuration (fast node program,
Fast-SSCL R1/SPC forks, float32, min-sum f, |llr| path metric, no genie)
it is the plain version of the hand-written CUDA decode kernels
(ops/cuda_scl.py, csrc/scl_decode.cu): the CPU runs it, and the card
checks the kernels against it. It also takes the JAX package's decoder
knobs (genie, fast, fast_r1_scl, llr_dtype, f_mode, pm_mode), which the
kernels do not: `build_scl_decoder` runs a decode with a knob as this op
program on the caller's device.

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

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops.kernel_proc import StageProcessor
from polar_tpu_torch.ops.program import (build_program, staged_inverse_kernels,
                                         subtree_items, subtree_spec)
from polar_tpu_torch.ops.schedule import build_schedule
from polar_tpu_torch.utils.device import resolve_device
from polar_tpu_torch.utils.spans import span

BIG = 1e30   # metric penalty of a CRC failure; initial metric of paths 1..P-1
MAX_LIST = 32
KERNEL_SIZES = (2, 4, 8, 16)
BIG_STAGE_BACKENDS = ("xla", "pallas")
SUBTREE_BACKENDS = ("none", "pallas")
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
    pos = epilogue_tables(spec, u_all.device)[0]
    return finalize(spec, P, u_all, u_all[pos], pm)


@functools.lru_cache(maxsize=None)
def epilogue_tables(spec: CodeSpec, device: torch.device):
    """(payload rows [K + n_crc] int64, CRC generator [K, n_crc] and offset
    [n_crc] float64, or None without a CRC) on `device`, uploaded once: a
    walk on the card then copies nothing from the host (a pageable copy
    syncs the stream, and a CUDA graph capture cannot hold it)."""
    pos = torch.as_tensor(spec.info_positions, device=device)
    if spec.crc is None:
        return pos, None, None
    k = spec.K
    return (pos,
            torch.as_tensor(spec.crc.generator_matrix(k), device=device,
                            dtype=torch.float64),
            torch.as_tensor(spec.crc.offset_bits(k), device=device,
                            dtype=torch.float64))


def finalize(spec: CodeSpec, P: int, u_all, payload_all, pm) -> DecodeResult:
    """CRC check per path, best-path selection, [B]-major outputs. The CRC
    product runs in float64 (exact, and never TF32 on the card)."""
    bsz = pm.shape[-1]
    dev = pm.device
    if spec.crc is not None:
        k = spec.K
        _, g, off = epilogue_tables(spec, dev)
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


def _build_program_steps(spec: CodeSpec, P: int, stage_kernel: bool = False,
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
    procs = [StageProcessor(k, f_mode=f_mode, stage_kernel=stage_kernel)
             for k in spec.kernels]
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
                            trajectory: bool = False,
                            stage_kernel: bool = False,
                            subtree: bool = False, genie: bool = False,
                            fast: bool = True, fast_r1_scl: bool = True,
                            llr_dtype: torch.dtype = torch.float32,
                            f_mode: str = "minsum", pm_mode: str = "abs"):
    """decode(llrs [B, N] float32 tensor) -> DecodeResult, in plain PyTorch
    on the tensor's own device (the CUDA kernel's plain version).

    trajectory=True: decode returns the genealogy instead, (traj_bit
    [N, P, B] int8, traj_perm [Q, P, B] int64, pm [P, B] float32), which
    `scl_epilogue` over `trajectory_spans` turns into the DecodeResult (the
    plain version of the trajectory kernels).

    stage_kernel=True: the l > 2 trellis/table DOWN ops (0 <= i < l-1) run
    in the CUDA stage kernel (ops/cuda_stage.py) on a CUDA tensor; the
    rest stays PyTorch. This is the hybrid decoder of
    `build_scl_decoder(big_stage_backend="pallas")`; on a CPU tensor it is
    the plain decoder.

    genie, fast, fast_r1_scl, llr_dtype, f_mode, pm_mode: the JAX
    package's decoder knobs (polar_tpu/ops/scl.py build_scl_decoder), with
    its refusals (ValueError). f_mode="exact" or pm_mode="smooth" turns
    `fast` off; the stage kernel computes min-sum marginals only (with
    f_mode="exact" the l > 2 DOWNs stay PyTorch ops); with
    llr_dtype=torch.bfloat16 the channel LLRs and the
    carried LLR buffers are bfloat16, penalties and path metrics float32;
    genie (list size 1) decides every leaf as the all-zero codeword and
    returns u = the leaves' errors (lam < 0). The JAX package's
    unroll=False gives the same results as its unrolled program, which is
    the form this program always takes.

    subtree=True: the walk of `subtree_items` (the JAX package's
    subtree_backend="pallas"): each depth-1 child of more than one op is
    one call of its `core_sub` (ops/cuda_scl.py SubtreeKernel: the CUDA
    subtree kernel on a CUDA tensor, `build_plain_subtree` on a CPU one),
    one per distinct frozen slice; the rest runs as above. It computes what
    the default walk computes, bit for bit."""
    check_supported(spec, list_size)
    P = int(list_size)
    prog = _build_program_steps(spec, P, stage_kernel, genie=genie, fast=fast,
                                fast_r1_scl=fast_r1_scl, llr_dtype=llr_dtype,
                                f_mode=f_mode, pm_mode=pm_mode)
    steps = prog.steps
    items = [("op", j) for j in range(len(steps))]
    if subtree:
        from polar_tpu_torch.ops.cuda_scl import SubtreeKernel

        items = subtree_items(prog.program, spec)
        cores = {}
        for item in items:
            if item[0] == "sub" and item[2] not in cores:
                cores[item[2]] = SubtreeKernel(subtree_spec(spec, item[2]), P)
        items = [item if item[0] == "op" else
                 ("sub", item[1], cores[item[2]]) for item in items]
    # the walk as it is traced: each child alone ("walk.child"), each run of
    # consecutive ops between two children together ("walk.outer")
    runs: list[tuple] = []
    for item in items:
        if item[0] == "sub":
            runs.append(item)
        elif runs and runs[-1][0] == "op":
            runs[-1][1].append(steps[item[1]])
        else:
            runs.append(("op", [steps[item[1]]]))

    def sub(st: _State, t0: int, core) -> None:
        """One child through its core_sub (polar_tpu/ops/scl.py
        `_subtree_item`): its input, the stage-1 LLR block, is at
        identity slots, having just been written."""
        bits, perms, netp, x, pm = core(st.lam[0], st.pm)
        st.apply_perm(netp)
        st.pm = pm
        st.traj.extend((t0 + ts, nn, perms[q])
                       for q, (ts, nn) in enumerate(core.spans))
        st.traj_bit[t0:t0 + bits.shape[0]] = bits
        st.write_dec(1, int(prog.digits[t0, 0]), x)

    def decode(llrs: torch.Tensor) -> DecodeResult:
        if llrs.ndim != 2 or llrs.shape[1] != spec.N:
            raise ValueError(f"llrs must be [B, {spec.N}], got "
                             f"{tuple(llrs.shape)}")
        st = _State(spec, P, llrs, llr_dtype=llr_dtype)
        for run in runs:
            if run[0] == "op":
                with span("walk.outer"):
                    for fn, level, t0 in run[1]:
                        fn(st, level, t0)
            else:
                with span("walk.child"):
                    sub(st, run[1], run[2])
        with span("walk.epilogue"):
            if trajectory:
                return (st.traj_bit, torch.stack([e[2] for e in st.traj]),
                        st.pm)
            return scl_epilogue(spec, P, st.traj, st.traj_bit, st.pm)

    return decode


def build_plain_subtree(sub_spec: CodeSpec, list_size: int):
    """core_sub(lam1 [P, N1, B] float32, pm [P, B] float32) -> (bits
    [N1, P, B] int8, perms [Q, P, B] int64, netp [P, B] int64, x [P, N1, B]
    int8, pm' [P, B] float32): one depth-1 child `sub_spec`
    (ops/program.subtree_spec) decoded on its own, the plain version of the
    CUDA subtree kernel (the JAX package's `core_sub`,
    polar_tpu/ops/pallas_scl.py build_pallas_scl_kernel(subtree=True)).

    lam1 is path-bound (path p's row at the start is lam1[p]; every stage-1
    DOWN reads it through the fork permutations composed so far) and pm
    comes in as it is. bits are in each op's post-op path indexing at
    child-relative rows, perms are the ops' survival permutations (spans
    `trajectory_spans(sub_spec, P)`), netp is their composition and x the
    root re-encode of the stage-1 decisions through the child's first
    kernel (what the parent's UP would write), in final path indexing."""
    check_supported(sub_spec, list_size)
    P = int(list_size)
    prog = _build_program_steps(sub_spec, P)
    l0 = sub_spec.factors[0]

    def core_sub(lam1: torch.Tensor, pm: torch.Tensor):
        if lam1.ndim != 3 or tuple(lam1.shape[:2]) != (P, sub_spec.N):
            raise ValueError(f"lam1 must be [{P}, {sub_spec.N}, B], got "
                             f"{tuple(lam1.shape)}")
        if tuple(pm.shape) != (P, lam1.shape[2]):
            raise ValueError(f"pm must be [{P}, {lam1.shape[2]}], got "
                             f"{tuple(pm.shape)}")
        st = _State(sub_spec, P, lam1, pm=pm.to(torch.float32))
        for fn, level, t0 in prog.steps:
            fn(st, level, t0)
        x = prog.procs[0].reencode(st.dec_children(1, l0))
        return (st.traj_bit, torch.stack([e[2] for e in st.traj]), st.netmap,
                x.reshape(P, sub_spec.N, x.shape[-1]), st.pm)

    return core_sub


# The CUDA graphs of the walk (`ProgramDecoder` on a CUDA device) made and
# replayed in this process.
GRAPHS = {"captures": 0, "replays": 0}


class _Capture(NamedTuple):
    """One captured walk: the graph, its input and output buffers, and the
    launches of the port's kernels it holds, as (counter, name, count)."""
    graph: object             # torch.cuda.CUDAGraph
    llrs: torch.Tensor        # [B, N] float32, the input the graph reads
    out: tuple                # what the walk returned at capture
    launches: list


class _Walk:
    """The walk of one (spec, list size, route options), built once a
    process, and its CUDA graphs, one a batch size and device.

    The op program is fixed for a given batch: every shape is known on the
    host, the host tables are uploaded once (`StageProcessor.on_device`,
    `epilogue_tables`, the kernels' own), forks are sorts and gathers, and
    nothing is read back. So on the card the walk is captured once and
    each later decode is one graph launch. The walk, the graph and the
    device tables the graph's kernels point to are held here for the
    process: a decoder built again (every `run_sweep` call builds one)
    replays the graph its predecessor captured."""

    def __init__(self, walk):
        self.walk = walk
        self.graphs: dict = {}
        self.lock = threading.Lock()

    def __call__(self, llrs: torch.Tensor):
        key = (llrs.shape, llrs.device)
        with self.lock:
            cap = self.graphs.get(key)
            if cap is None:
                # eager first: lazy library loads, table uploads and the
                # kernels' attributes happen outside the capture
                out = self.walk(llrs)
                self.graphs[key] = self._capture(llrs)
                return out
            with span("walk.replay"), torch.cuda.device(llrs.device):
                cap.llrs.copy_(llrs)
                cap.graph.replay()
                GRAPHS["replays"] += 1
                for counter, name, n in cap.launches:
                    counter[name] += n
                # fresh tensors: the next replay overwrites the graph's own
                clones = [t.clone() for t in cap.out]
        if isinstance(cap.out, DecodeResult):
            return DecodeResult(*clones)
        return tuple(clones)

    def _capture(self, llrs: torch.Tensor) -> _Capture:
        from polar_tpu_torch.ops import cuda_scl, cuda_stage

        counters = (cuda_scl.LAUNCHES, cuda_stage.LAUNCHES)
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        static = llrs.clone(memory_format=torch.contiguous_format)
        with torch.cuda.device(llrs.device):
            # thread_local: a capture in one thread does not forbid
            # another thread's work on its own device
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(llrs.device),
                                  capture_error_mode="thread_local"):
                out = self.walk(static)
        # the capture launched nothing: its launches count at each replay
        launches = [(c, name, c[name] - b[name])
                    for c, b in zip(counters, before) for name in c
                    if c[name] != b[name]]
        for c, b in zip(counters, before):
            c.update(b)
        GRAPHS["captures"] += 1
        return _Capture(graph, static, out, launches)


@functools.lru_cache(maxsize=None)
def _shared_walk(spec: CodeSpec, list_size: int, options: tuple) -> _Walk:
    return _Walk(build_plain_scl_decoder(spec, list_size, **dict(options)))


class ProgramDecoder:
    """decode(llrs [B, N]) -> DecodeResult through `build_plain_scl_decoder`
    on `device`: the op program in PyTorch tensor ops, with the stage
    kernel for the l > 2 DOWN ops (`stage_kernel`) and the subtree kernel
    for depth-1 children (`subtree`) on a CUDA device. `route` names the
    route, for a reader of the decoder.

    On a CUDA device the first decode of a batch size walks eagerly and
    captures the walk as a CUDA graph; every later one (of any decoder of
    the same spec, list size and options, in this process) replays it and
    returns fresh tensors. On the CPU it walks eagerly. `walk` is the
    eager walk on either."""

    def __init__(self, spec: CodeSpec, list_size: int, device: torch.device,
                 route: str, **options):
        self.device = device
        self.route = route
        self._walk = _shared_walk(spec, int(list_size),
                                  tuple(sorted(options.items())))
        self.walk = self._walk.walk

    def __call__(self, llrs) -> DecodeResult:
        with span("scl.decode"):
            llrs = torch.as_tensor(llrs, dtype=torch.float32,
                                   device=self.device)
            if llrs.device.type == "cuda":
                return self._walk(llrs)
            return self.walk(llrs)


def build_scl_decoder(spec: CodeSpec, list_size: int, device="cuda",
                      genie: bool = False, fast: bool = True,
                      fast_r1_scl: bool = True, llr_dtype=torch.float32,
                      unroll: bool = True, f_mode: str = "minsum",
                      pm_mode: str = "abs", big_stage_backend: str = "xla",
                      subtree_backend: str = "none"):
    """Returns decode(llrs [B, N]) -> DecodeResult on `device`.

    The LLRs are moved to `device`. With every knob at its default, on a
    CUDA device the decode runs in the hand-written kernels
    (ops/cuda_scl.py SclDecoder); on the CPU in the plain PyTorch version
    above. Raises RuntimeError when `device` is CUDA and no card is
    present. The decoder's `route` attribute names its route.

    big_stage_backend: "xla" (default) decodes in the CUDA decode kernels,
    l > 2 stages included. "pallas" (the JAX package's name, kept so its
    callers work unchanged) selects the hybrid decoder: the op program in
    PyTorch tensor ops on `device`, with every l > 2 trellis/table DOWN
    op (0 <= i < l-1) one launch of the CUDA stage kernel
    (ops/cuda_stage.py); on the CPU it equals the plain decoder.

    subtree_backend: "none" (default) or "pallas" (the JAX name): the op
    program in PyTorch tensor ops on `device` with each depth-1 child of
    more than one op one launch of the CUDA subtree kernel (ops/cuda_scl.py
    SubtreeKernel), and the outer l > 2 DOWN ops as `big_stage_backend`
    says (one stage-kernel launch each with "pallas", PyTorch ops with
    "xla"). This is the route of codes whose decode state does not fit a
    block's shared memory (mixed_scl32); on the CPU it equals the plain
    decoder.

    genie, fast, fast_r1_scl, llr_dtype, unroll, f_mode, pm_mode: the JAX
    package's knobs (polar_tpu/ops/scl.py build_scl_decoder; see
    `build_plain_scl_decoder`), with its refusals: genie with a list size
    other than 1, an unknown pm_mode or f_mode, and any non-default knob
    with subtree_backend="pallas" raise ValueError. The decode kernels
    take defaults only, as the Pallas ones do: a decode with any knob
    off its default runs as the op program in PyTorch tensor ops on
    `device`, the counterpart of the JAX package's XLA decoder, the
    l > 2 DOWN ops as `big_stage_backend` says. This route is chosen by
    the arguments, not by a failure.
    """
    check_knobs(list_size, genie, f_mode, pm_mode)
    if big_stage_backend not in BIG_STAGE_BACKENDS:
        raise ValueError(f"unknown big_stage_backend {big_stage_backend!r}")
    if subtree_backend not in SUBTREE_BACKENDS:
        raise ValueError(f"unknown subtree_backend {subtree_backend!r}")
    knobs = dict(genie=genie, fast=fast, fast_r1_scl=fast_r1_scl,
                 llr_dtype=llr_dtype, f_mode=f_mode, pm_mode=pm_mode)
    changed = [f"{k}={v}" for k, v in dict(knobs, unroll=unroll).items()
               if v != KNOB_DEFAULTS[k]]
    stage = big_stage_backend == "pallas"
    subtree = subtree_backend == "pallas"
    if subtree and changed:
        raise ValueError("subtree_backend='pallas' requires the "
                         "unrolled default-mode program with "
                         "llr_dtype=float32 (the subtree kernel "
                         "computes in f32; a bf16 outer program "
                         "would silently break bit-identity)")
    dev = resolve_device(device)
    if not (changed or stage or subtree):
        from polar_tpu_torch.ops.cuda_scl import SclDecoder
        return SclDecoder(spec, list_size, dev)
    route = ("op program" + (", stage kernel" if stage else "")
             + (", subtree kernel" if subtree else "")
             + (f", knobs {' '.join(changed)}" if changed else ""))
    return ProgramDecoder(spec, list_size, dev, route, stage_kernel=stage,
                          subtree=subtree, **knobs)


def build_sc_decoder(spec: CodeSpec, device="cuda"):
    """Plain SC = SCL with list_size 1."""
    return build_scl_decoder(spec, 1, device=device)
