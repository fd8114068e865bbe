"""Minimal-trellis construction + batched min-plus Viterbi pass (PyTorch).

Counterpart of polar_tpu/kernels/trellis.py. The host builders
(`build_trellis`, `tail_trellis`, `tail_syndrome_cols`) are numpy copies;
the device passes (`syndrome_min_cost`, `min_path_cost`) are PyTorch with
the same expression order, so they give the same floats as the JAX
package on the same inputs.

Semantics are identical to the tail-table backend in ops/kernel_proc.py:
both compute the exact min-sum path cost over the tail code
span(rows i+1..l-1) of an l x l kernel. States at boundary t are cosets of
the past-projection of the tail code modulo its codewords supported
entirely in the past (the minimal trellis), built by direct enumeration.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from portbench.ref.gf2 import gf2_null_space, gf2_rank, gf2_rref

INF = np.float32(3e38) / 4


@dataclasses.dataclass(frozen=True)
class Trellis:
    """Dense minimal trellis: trans[t, b] is [S, S] with 0 where a section-t
    edge labelled bit b connects the states, +INF elsewhere."""
    n: int
    s_max: int
    trans: np.ndarray  # [n, 2, S, S] float32 (0 / INF)
    state_profile: tuple[int, ...]


def _subcode_basis(basis: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Basis of codewords supported entirely within columns [lo, hi): the
    rows of the rref of [outside | inside] whose outside part is zero."""
    if basis.size == 0:
        return basis.reshape(0, basis.shape[1] if basis.ndim == 2 else 0)
    n = basis.shape[1]
    outside = [c for c in range(n) if not (lo <= c < hi)]
    inside = [c for c in range(n) if lo <= c < hi]
    perm = outside + inside
    rr, _ = gf2_rref(basis[:, perm])
    keep = [r for r in range(rr.shape[0])
            if rr[r, :len(outside)].max(initial=0) == 0 and rr[r].any()]
    out = np.zeros((len(keep), n), dtype=np.uint8)
    inv = np.argsort(perm)
    for j, r in enumerate(keep):
        out[j] = rr[r][inv]
    return out


def build_trellis(basis: np.ndarray, n: int) -> Trellis:
    """Minimal trellis of the code spanned by `basis` rows (length n)."""
    basis = np.asarray(basis, dtype=np.uint8).reshape(-1, n)
    k = gf2_rank(basis) if basis.size else 0
    if k > 16:
        raise ValueError("trellis enumeration limited to k <= 16")
    msgs = ((np.arange(1 << basis.shape[0])[:, None]
             >> np.arange(basis.shape[0])[None, :]) & 1).astype(np.uint8)
    words = (msgs.astype(np.int64) @ basis.astype(np.int64) % 2).astype(np.uint8)
    words = np.unique(words, axis=0)

    # state labels per boundary: past-projections reduced by the basis of
    # the past-supported subcode (modded out)
    labels = []
    profile = []
    for t in range(n + 1):
        past = words[:, :t]
        past_sub = _subcode_basis(basis, 0, t)[:, :t] if t else \
            np.zeros((0, 0), np.uint8)
        red = past.copy()
        if past_sub.size:
            rr, piv = gf2_rref(past_sub)
            for r, p in zip(rr, piv):
                flip = red[:, p] == 1
                red[flip] ^= r[None, :]
        uniq, ids = np.unique(red, axis=0, return_inverse=True)
        labels.append(ids.reshape(-1))
        profile.append(len(uniq))
    s_max = max(profile)

    trans = np.full((n, 2, s_max, s_max), INF, dtype=np.float32)
    for t in range(n):
        trans[t, words[:, t], labels[t], labels[t + 1]] = 0.0
    return Trellis(n=n, s_max=s_max, trans=trans,
                   state_profile=tuple(profile))


@lru_cache(maxsize=None)
def tail_trellis(kernel_bytes: bytes, l: int, i: int) -> Trellis:
    kernel = np.frombuffer(kernel_bytes, dtype=np.uint8).reshape(l, l)
    return build_trellis(kernel[i + 1:], l)


@lru_cache(maxsize=None)
def tail_syndrome_cols(kernel_bytes: bytes, l: int, i: int
                       ) -> tuple[int, tuple[int, ...]]:
    """Syndrome-trellis form of `tail_trellis`: the tail code
    span(rows i+1..l-1) as its parity-check matrix H [r, l], returned as
    (n_states = 2^r, the syndrome column of each position as an int).

    States are partial syndromes; bit 1 at position t XORs the state with
    column t; valid paths end at syndrome 0. The reachable-state partition
    is the minimal trellis's, so a min-plus pass over it gives the same
    floats as `min_path_cost`, and the bit-1 transition is an XOR
    relabelling of the state axis (a warp shuffle in the CUDA kernels)."""
    kernel = np.frombuffer(kernel_bytes, dtype=np.uint8).reshape(l, l)
    h = gf2_null_space(kernel[i + 1:])           # [r, l]
    h = np.atleast_2d(h).reshape(-1, l)
    r = h.shape[0]
    cols = tuple(int((h[:, t].astype(np.int64) << np.arange(r)).sum())
                 for t in range(l))
    return (1 << r), cols


def syndrome_min_cost(n_states: int, cols, lam_adj: torch.Tensor
                      ) -> torch.Tensor:
    """min_path_cost over the syndrome trellis: [..., l, n, B] -> [..., n, B].
    Each alpha update is a 2-operand add and an order-free min, section by
    section, as in the JAX package and the CUDA kernels."""
    l = lam_adj.shape[-3]
    shape = lam_adj.shape[:-3] + lam_adj.shape[-2:]
    zero = torch.zeros(shape, dtype=torch.float32, device=lam_adj.device)
    inf = torch.full(shape, float(INF), dtype=torch.float32,
                     device=lam_adj.device)
    alpha = [zero if s == 0 else inf for s in range(n_states)]
    for t in range(l):
        lam_t = lam_adj[..., t, :, :]
        pen0 = torch.clamp_min(-lam_t, 0.0)
        pen1 = torch.clamp_min(lam_t, 0.0)
        c = cols[t]
        alpha = [torch.minimum(alpha[s] + pen0, alpha[s ^ c] + pen1)
                 for s in range(n_states)]
    return alpha[0]


def min_path_cost(trellis: Trellis, lam_adj: torch.Tensor) -> torch.Tensor:
    """Min-sum path cost over the trellis.

    lam_adj: [..., l, n, B] coset-adjusted LLRs. Returns [..., n, B]: the
    min over codewords c of sum_t |lam_t| * [hard(lam_t) != c_t]. The state
    axis leads; the batch stays last."""
    s = trellis.s_max
    batch_shape = lam_adj.shape[:-3] + lam_adj.shape[-2:]
    alpha = torch.full((s,) + batch_shape, float(INF), dtype=torch.float32,
                       device=lam_adj.device)
    alpha[0] = 0.0
    trans = torch.as_tensor(trellis.trans, device=lam_adj.device)
    nd = alpha.ndim - 1
    for t in range(trellis.n):
        lam_t = lam_adj[..., t, :, :]
        pen = torch.stack([torch.clamp_min(-lam_t, 0.0),
                           torch.clamp_min(lam_t, 0.0)])      # [2, ..., n, B]
        # alpha'[s'] = min over (bit b, state s) of alpha[s] + tr[b, s, s']
        # + pen[b], in the JAX package's order: (alpha + tr), min, + pen
        tr_b = trans[t].reshape((2, s, s) + (1,) * nd)
        expanded = alpha[None, :, None] + tr_b                # [2, S, S', ...]
        best = torch.amin(expanded, dim=1) + pen[:, None]     # [2, S', ...]
        alpha = torch.amin(best, dim=0)
    return torch.amin(alpha, dim=0)
