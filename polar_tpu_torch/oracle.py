"""Slow, obviously-correct numpy SC/SCL oracle decoder: the port's ground
truth.

The port's own copy of polar_tpu/oracle.py (same names, same float64
numpy arithmetic); it stays numpy because ground truth is host code, not
a device path. The port's decoders (plain and kernels) must bit-match it
on random noisy frames (SURVEY.md §4 "Oracle cross-check"). It mirrors
the reference C++ decoder's *contract* (SURVEY.md C8/C9) with the exact
conventions the device path uses:

- per-kernel input LLRs by brute-force min-sum marginalization
  (equivalent to min-sum f/g for the 2x2 kernel and to min-sum trellis
  processing for large kernels),
- path metric PM += |llr| on sign mismatch (Balatsoukas-Stimming,
  arXiv:1411.7282),
- 2L -> L stable sort, candidate order c = bit * L + path (ties prefer
  bit 0, then lower path index — the device top_k convention),
- CRC selection: lowest-PM survivor whose CRC checks, else lowest-PM.

Complexity is O(N^2 * L * 2^l) per codeword — for tests only (N <= 256).
"""
from __future__ import annotations

import numpy as np

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.utils.gf2 import gf2_matmul


def kernel_input_llr(kernel: np.ndarray, i: int, llrs: np.ndarray,
                     prev_u: np.ndarray, f_mode: str = "minsum") -> float:
    """LLR of kernel input i given output llrs and decided inputs.

    minsum: cost(x) = sum_j |llr_j| * [hard(llr_j) != x_j];
    llr_i = min cost over coset(u_i=1) - min cost over coset(u_i=0).
    exact: llr_i = lse over coset(u_i=0) of (-cost) - lse over coset(u_i=1)
    (true sum-product marginal; the device f_mode="exact" counterpart).
    """
    l = kernel.shape[0]
    n_free = l - i - 1
    abs_l = np.abs(llrs)
    hard = (llrs < 0).astype(np.uint8)
    base = gf2_matmul(prev_u.reshape(1, -1), kernel[:i]).ravel() if i else \
        np.zeros(l, dtype=np.uint8)
    if n_free:
        msgs = ((np.arange(1 << n_free)[:, None] >> np.arange(n_free)[None, :]) & 1
                ).astype(np.uint8)
        tails = gf2_matmul(msgs, kernel[i + 1:])
    else:
        tails = np.zeros((1, l), dtype=np.uint8)
    costs = []
    for ui in (0, 1):
        x = tails ^ base[None, :] ^ (kernel[i][None, :] if ui else 0)
        cost = (abs_l[None, :] * (x != hard[None, :])).sum(axis=1)
        if f_mode == "exact":
            costs.append(-np.logaddexp.reduce(-cost))
        else:
            costs.append(cost.min())
    return float(costs[1] - costs[0])


def _encode_sub(spec: CodeSpec, stage: int, u: np.ndarray) -> np.ndarray:
    """Encode leaves u (length n_{stage-1}) through kernels K_stage..K_m."""
    factors = spec.factors[stage - 1:]
    t = np.asarray(u, dtype=np.uint8).reshape(factors) if factors else u
    for ax, l in enumerate(factors):
        k = spec.kernels[stage - 1 + ax]
        t = np.moveaxis(
            np.tensordot(t.astype(np.int64), k.astype(np.int64), axes=[[ax], [0]]) % 2,
            -1, ax).astype(np.uint8)
    return t.reshape(-1)


def llr_at_next_leaf(spec: CodeSpec, channel_llrs: np.ndarray,
                     u_prefix: np.ndarray, f_mode: str = "minsum") -> float:
    """LLR of leaf t = len(u_prefix) given channel llrs and decided prefix."""

    def rec(stage: int, llrs: np.ndarray, known: np.ndarray) -> float:
        if stage > len(spec.factors):
            assert llrs.size == 1 and known.size == 0
            return float(llrs[0])
        l = spec.factors[stage - 1]
        n_child = llrs.size // l
        view = llrs.reshape(l, n_child)
        i_cur = known.size // n_child
        prev_w = np.zeros((i_cur, n_child), dtype=np.uint8)
        for j in range(i_cur):
            prev_w[j] = _encode_sub(spec, stage + 1,
                                    known[j * n_child:(j + 1) * n_child])
        child = np.array([
            kernel_input_llr(spec.kernels[stage - 1], i_cur, view[:, b],
                             prev_w[:, b], f_mode=f_mode)
            for b in range(n_child)
        ])
        return rec(stage + 1, child, known[i_cur * n_child:])

    return rec(1, np.asarray(channel_llrs, dtype=np.float64),
               np.asarray(u_prefix, dtype=np.uint8))


def _penalty(lam: float, bit: int, pm_mode: str) -> float:
    """Path-metric penalty for deciding `bit` at a leaf with LLR `lam`."""
    if pm_mode == "smooth":
        return float(np.logaddexp(0.0, -(1.0 - 2.0 * bit) * lam))
    return abs(lam) if (lam < 0) != bool(bit) else 0.0


def sc_decode(spec: CodeSpec, channel_llrs: np.ndarray,
              f_mode: str = "minsum") -> np.ndarray:
    """Plain SC: returns the decided u vector [N]."""
    u = np.zeros(spec.N, dtype=np.uint8)
    for t in range(spec.N):
        lam = llr_at_next_leaf(spec, channel_llrs, u[:t], f_mode=f_mode)
        u[t] = 0 if spec.frozen[t] else int(lam < 0)
    return u


def scl_decode(spec: CodeSpec, channel_llrs: np.ndarray, list_size: int,
               return_all: bool = False, f_mode: str = "minsum",
               pm_mode: str = "abs"):
    """CRC-aided SCL. Returns decided u [N] (best path after CRC selection)."""
    paths: list[tuple[float, list[int]]] = [(0.0, [])]
    for t in range(spec.N):
        lams = [llr_at_next_leaf(spec, channel_llrs,
                                 np.array(p, dtype=np.uint8), f_mode=f_mode)
                for _, p in paths]
        if spec.frozen[t]:
            paths = [
                (pm + _penalty(lam, 0, pm_mode), p + [0])
                for (pm, p), lam in zip(paths, lams)
            ]
        else:
            cands = []
            # candidate order: bit-major then path index (device top_k tie rule)
            for bit in (0, 1):
                for (pm, p), lam in zip(paths, lams):
                    cands.append((pm + _penalty(lam, bit, pm_mode), p + [bit]))
            order = sorted(range(len(cands)), key=lambda c: (cands[c][0], c))
            paths = [cands[c] for c in order[:list_size]]
    if return_all:
        return paths
    best = _select_path(spec, paths)
    return np.array(best[1], dtype=np.uint8)


def _select_path(spec: CodeSpec, paths):
    paths = sorted(paths, key=lambda x: x[0])
    if spec.crc is None:
        return paths[0]
    for pm, p in paths:
        u = np.array(p, dtype=np.uint8)
        payload = u[spec.info_positions]
        info, crc_bits = payload[:spec.K], payload[spec.K:]
        if np.array_equal(spec.crc.compute(info), crc_bits):
            return (pm, p)
    return paths[0]
