"""Batched SC / CRC-aided SC-list decoder, plain PyTorch version.

Counterpart of polar_tpu/ops/scl.py in its default configuration (fast
node program, Fast-SSCL R1/SPC forks, float32, min-sum f, |llr| path
metric, no genie). It is the plain version of the hand-written CUDA
decode kernel (ops/cuda_scl.py, csrc/scl_decode.cu): the CPU runs it,
and the card checks the kernel against it.

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

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops.program import build_program
from polar_tpu_torch.ops.schedule import build_schedule
from polar_tpu_torch.utils.device import resolve_device

BIG = 1e30   # metric penalty of a CRC failure; initial metric of paths 1..P-1
MAX_LIST = 8

_NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 item 7: decoder knobs; "
               "item 6: l > 2 kernels)")


class DecodeResult(NamedTuple):
    u: torch.Tensor        # [B, N] int8 best path's u decisions
    payload: torch.Tensor  # [B, K + n_crc] int8 unfrozen slots of u
    crc_ok: torch.Tensor   # [B] bool: best path passed CRC (True if no CRC)
    pm: torch.Tensor       # [B] float32 best path metric


def check_supported(spec: CodeSpec, list_size: int) -> None:
    """Raise for what the port does not decode yet."""
    if any(f != 2 for f in spec.factors):
        raise NotImplementedError(
            f"factors {spec.factors}: kernels of size > 2 (StageProcessor, "
            "ops/kernel_proc.py) are not ported yet (ROADMAP Queue 1 item 6)")
    if not 1 <= int(list_size) <= MAX_LIST:
        raise ValueError(f"list_size {list_size} outside 1..{MAX_LIST}; "
                         "L=32 comes with the mixed_scl32 slice")


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


def apply_inverse(x: torch.Tensor) -> torch.Tensor:
    """u = x F^{(x)k} for Arikan blocks [P, n, B] (F is self-inverse over
    GF(2)): butterfly XORs on int8."""
    p_, n, b = x.shape
    h = n // 2
    while h >= 1:
        t = x.reshape(p_, n // (2 * h), 2, h, b)
        x = torch.stack([t[:, :, 0] ^ t[:, :, 1], t[:, :, 1]], dim=2)
        x = x.reshape(p_, n, b)
        h //= 2
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
    """Decoder state of one batch: buffers, lazy maps, metrics, genealogy."""

    def __init__(self, spec: CodeSpec, P: int, llrs: torch.Tensor):
        bsz = llrs.shape[0]
        dev = llrs.device
        m = len(spec.factors)
        ns = spec.block_sizes
        self.lam0 = llrs.T.to(torch.float32)                       # [N, B]
        self.iota = torch.arange(P, device=dev)[:, None].expand(P, bsz)
        # index s-1 holds stage s (s = 1..m)
        self.lam = [torch.zeros((P, ns[s], bsz), device=dev)
                    for s in range(1, m + 1)]
        self.dec = [torch.zeros((2, P, ns[s], bsz), dtype=torch.int8,
                                device=dev) for s in range(1, m + 1)]
        self.rlam = [self.iota for _ in range(m)]
        self.rdec = [[self.iota, self.iota] for _ in range(m)]
        self.pm = torch.full((P, bsz), BIG, device=dev)
        self.pm[0] = 0.0
        self.traj_bit = torch.zeros((spec.N, P, bsz), dtype=torch.int8,
                                    device=dev)
        self.traj = []

    def apply_perm(self, perm: torch.Tensor) -> None:
        """Permute every path->slot map by a survival permutation [P, B]."""
        self.rlam = [r.gather(0, perm) for r in self.rlam]
        self.rdec = [[r.gather(0, perm) for r in rs] for rs in self.rdec]

    def write_dec(self, d: int, child: int, block: torch.Tensor) -> None:
        """Record a depth-d node's hard output block [P, n_d, B] as child
        `child` of its parent's kernel."""
        self.dec[d - 1][child] = block
        self.rdec[d - 1][child] = self.iota

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


def build_plain_scl_decoder(spec: CodeSpec, list_size: int,
                            trajectory: bool = False):
    """decode(llrs [B, N] float32 tensor) -> DecodeResult, in plain PyTorch
    on the tensor's own device (the CUDA kernel's plain version).

    trajectory=True: decode returns the genealogy instead, (traj_bit
    [N, P, B] int8, traj_perm [Q, P, B] int64, pm [P, B] float32), which
    `scl_epilogue` over `trajectory_spans` turns into the DecodeResult (the
    plain version of the trajectory kernels)."""
    check_supported(spec, list_size)
    P = int(list_size)
    m = len(spec.factors)
    ns = spec.block_sizes
    digits = build_schedule(spec).digits
    frozen = spec.frozen.astype(bool)
    program = build_program(spec, scl=(P > 1))

    def down(st: _State, s: int, t0: int, fresh: bool) -> None:
        n = ns[s]
        if s == 1:
            view = st.lam0.reshape(1, 2, n, -1)
        else:
            view = pgather(st.lam[s - 2], st.rlam[s - 2]).reshape(P, 2, n, -1)
        a, b = view[:, 0], view[:, 1]
        if fresh:
            sign = torch.where((a < 0) ^ (b < 0), -1.0, 1.0)
            llr = sign * torch.minimum(a.abs(), b.abs())
        else:
            d0 = st.dec_child(s, 0)
            llr = a * (1.0 - 2.0 * d0.to(torch.float32)) + b
        st.lam[s - 1] = llr.expand(P, n, llr.shape[-1]).contiguous()
        st.rlam[s - 1] = st.iota

    def up(st: _State, s: int, t0: int) -> None:
        d0, d1 = st.dec_child(s, 0), st.dec_child(s, 1)
        x = torch.cat([d0 ^ d1, d1], dim=1)                       # [P, n_{s-1}, B]
        st.write_dec(s - 1, int(digits[t0, s - 2]), x)

    def r0(st: _State, d: int, t0: int) -> None:
        lam = st.lam[d - 1]
        st.pm = st.pm + tree_sum(torch.clamp_min(-lam, 0.0))
        zeros = torch.zeros_like(lam, dtype=torch.int8)
        st.write_traj(t0, st.iota, zeros)
        st.write_dec(d, int(digits[t0, d - 1]), zeros)

    def rep(st: _State, d: int, t0: int) -> None:
        lam = st.lam[d - 1]
        n = ns[d]
        s0 = tree_sum(torch.clamp_min(-lam, 0.0))
        s1 = tree_sum(torch.clamp_min(lam, 0.0))
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
        st.write_traj(t0, node_map, apply_inverse(xhat))
        st.write_dec(d, int(digits[t0, d - 1]), xhat)

    def r1(st: _State, d: int, t0: int) -> None:
        lam = st.lam[d - 1]
        n = ns[d]
        hd = (lam < 0).to(torch.int8)
        if P == 1:
            st.write_traj(t0, st.iota, apply_inverse(hd))
            st.write_dec(d, int(digits[t0, d - 1]), hd)
            return
        # Fast-SSCL: q keep/flip forks on the least reliable positions;
        # flips are recorded per round and mapped to final indexing after
        q = min(P - 1, n)
        vals, poss = extract_mins(lam.abs(), q)
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
        absl = lam.abs()
        if P == 1:
            vals, poss = extract_mins(absl, 1)
            xhat = flip_at(hd, poss[0], par)
            st.pm = st.pm + vals[0] * par.to(torch.float32)
            st.write_traj(t0, st.iota, apply_inverse(xhat))
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
        pen0 = torch.clamp_min(-lam, 0.0)
        pen1 = torch.clamp_min(lam, 0.0)
        perm = st.iota
        if frozen[t]:
            bit = torch.zeros_like(lam, dtype=torch.int8)
            st.pm = st.pm + pen0
        elif P == 1:
            bit = (lam < 0).to(torch.int8)
            st.pm = st.pm + torch.where(bit == 1, pen1, pen0)
        else:
            st.pm, perm, bit = fork2(st.pm, pen0, pen1)
            st.apply_perm(perm)
        st.write_traj(t, perm, bit[:, None, :])
        st.write_dec(m, int(digits[t, m - 1]), bit[:, None, :])

    handlers = {
        "DOWN_FRESH": lambda st, s, t0: down(st, s, t0, True),
        "DOWN_DYN": lambda st, s, t0: down(st, s, t0, False),
        "UP": up, "R0": r0, "REP": rep, "R1": r1, "SPC": spc, "LEAF": leaf,
    }
    steps = [(handlers[op.kind], op.level, op.t0) for op in program.ops]

    def decode(llrs: torch.Tensor) -> DecodeResult:
        if llrs.ndim != 2 or llrs.shape[1] != spec.N:
            raise ValueError(f"llrs must be [B, {spec.N}], got "
                             f"{tuple(llrs.shape)}")
        st = _State(spec, P, llrs)
        for fn, level, t0 in steps:
            fn(st, level, t0)
        if trajectory:
            return (st.traj_bit, torch.stack([e[2] for e in st.traj]), st.pm)
        return scl_epilogue(spec, P, st.traj, st.traj_bit, st.pm)

    return decode


def build_scl_decoder(spec: CodeSpec, list_size: int, device="cuda",
                      genie: bool = False, fast: bool = True,
                      fast_r1_scl: bool = True, llr_dtype=torch.float32,
                      unroll: bool = True, f_mode: str = "minsum",
                      pm_mode: str = "abs", big_stage_backend: str = "xla",
                      subtree_backend: str = "none"):
    """Returns decode(llrs [B, N]) -> DecodeResult on `device`.

    The LLRs are moved to `device`. On a CUDA device the decode runs in
    the hand-written kernel (ops/cuda_scl.py); on the CPU in the plain
    PyTorch version above. Raises RuntimeError when `device` is CUDA and
    no card is present. The knobs keep the JAX package's names; only
    their defaults are ported, and any other value raises
    NotImplementedError.
    """
    knobs = {"genie": (genie, False), "fast": (fast, True),
             "fast_r1_scl": (fast_r1_scl, True),
             "llr_dtype": (llr_dtype, torch.float32), "unroll": (unroll, True),
             "f_mode": (f_mode, "minsum"), "pm_mode": (pm_mode, "abs"),
             "big_stage_backend": (big_stage_backend, "xla"),
             "subtree_backend": (subtree_backend, "none")}
    for name, (val, default) in knobs.items():
        if val != default:
            raise NotImplementedError(f"{name}={val!r} {_NOT_PORTED}")
    dev = resolve_device(device)
    from polar_tpu_torch.ops.cuda_scl import SclDecoder
    return SclDecoder(spec, list_size, dev)


def build_sc_decoder(spec: CodeSpec, device="cuda"):
    """Plain SC = SCL with list_size 1."""
    return build_scl_decoder(spec, 1, device=device)
