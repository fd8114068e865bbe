"""Per-stage kernel-input LLR processors (PyTorch).

Counterpart of polar_tpu/ops/kernel_proc.py. For an l x l kernel K:

1. Prior decisions u_0..u_{i-1} are absorbed as a coset sign flip of the
   output LLRs: lam' = lam * (1 - 2 * coset), coset = (prior u) @ K mod 2.
2. The input-i LLR is the min-sum (max-log) marginal over the free tail
   bits: with T_i the +-1 table of all tail codewords span(rows i+1..) and
   s_i = 1 - 2 * row_i,
       llr_i = (max(lam' @ T_i) - max((lam' * s_i) @ T_i)) / 2,
   computed by a syndrome trellis where that is cheaper (small i) and by
   the table otherwise. For the 2x2 kernel the closed forms f and g.

Arrays keep the JAX package's layout: lam views are [P, l, n, B] with P
list paths, l kernel size, n positions and B codewords. Every expression
keeps the JAX package's float order (fixed pairwise tree over l, +-1
multiplies, 2-operand adds and order-free mins/maxes), so both packages
and the CUDA kernels give the same floats on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.ref.arikan import f_exact, f_minsum

_CHUNK = 512             # at most this many tail-table columns at once
_TERM_BUDGET = 1 << 27   # elements of the l tree terms of one chunk


def tree_corr(lam_adj: torch.Tensor, t) -> torch.Tensor:
    """Correlations of lam_adj [..., l, n, B] against table columns
    t [l, C] -> [..., C, n, B], summed over l as the fixed pairwise tree
    ((0+1)+(2+3))+... (the JAX package's and the CUDA kernels' order)."""
    t = torch.as_tensor(t, dtype=lam_adj.dtype, device=lam_adj.device)
    l = t.shape[0]
    pre = (1,) * (lam_adj.ndim - 3)
    terms = [lam_adj[..., j, None, :, :] * t[j].reshape(pre + (-1, 1, 1))
             for j in range(l)]
    while len(terms) > 1:
        nxt = [terms[k] + terms[k + 1] for k in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _tail_table(kernel: np.ndarray, i: int) -> np.ndarray:
    """All codewords of span(rows i+1..l-1) as a +-1 matrix [l, 2^(l-1-i)];
    column c is the codeword of message bits c (bit g <-> row i+1+g)."""
    l = kernel.shape[0]
    n_free = l - 1 - i
    msgs = ((np.arange(1 << n_free)[:, None] >> np.arange(n_free)[None, :]) & 1)
    x = (msgs.astype(np.int64) @ kernel[i + 1:].astype(np.int64)) % 2
    return (1.0 - 2.0 * x.T).astype(np.float32)  # [l, C]


def _chunks(lam: torch.Tensor, c: int):
    """Column ranges of a tail table of c columns, sized so that one
    chunk's l tree terms stay within _TERM_BUDGET elements (max and
    logaddexp over chunks: the chunking cannot change a max)."""
    per_col = lam.numel()          # one column's l terms
    step = max(1, min(c, _CHUNK, _TERM_BUDGET // max(1, per_col)))
    return [(c0, min(c, c0 + step)) for c0 in range(0, c, step)]


class StageProcessor:
    """LLR processor for one kernel stage: host-built tables, applied to
    tensors on their own device.

    f_mode: "minsum" (max-log marginals: f/g for the 2x2 kernel,
    trellis/max-correlation for larger kernels) or "exact" (sum-product:
    boxplus for 2x2, logsumexp over the full coset tables for larger
    kernels; a correctness path).
    """

    def __init__(self, kernel: np.ndarray, f_mode: str = "minsum"):
        if f_mode not in ("minsum", "exact"):
            raise ValueError(f"unknown f_mode {f_mode!r}")
        self.kernel = np.asarray(kernel, dtype=np.uint8)
        self.l = int(kernel.shape[0])
        self.f_mode = f_mode
        self.row_signs = 1.0 - 2.0 * self.kernel.astype(np.float32)
        # column k of K as a bit mask over rows j (coset folds, re-encode)
        self.kcol = [int((self.kernel[:, k].astype(np.int64)
                          << np.arange(self.l)).sum()) for k in range(self.l)]
        if self.l > 2 and f_mode == "exact":
            # exact marginals need every coset: the table for every input
            self.backend = ["table"] * self.l
            self.tables = [_tail_table(self.kernel, i) for i in range(self.l)]
        elif self.l > 2:
            from portbench.ref.trellis import (tail_syndrome_cols,
                                                         tail_trellis)

            kb = self.kernel.tobytes()
            self.trellises = [tail_trellis(kb, self.l, i)
                              for i in range(self.l)]
            # the tail table costs O(2^(l-1-i)) columns, the minimal
            # trellis O(l * S_i^2) min-adds: the cheaper one per input
            self.backend = [
                "trellis" if self.trellises[i].s_max ** 2 < (1 << (self.l - 1 - i))
                else "table"
                for i in range(self.l)]
            self.tables = [None if self.backend[i] == "trellis"
                           else _tail_table(self.kernel, i)
                           for i in range(self.l)]
            # trellis inputs run as a syndrome trellis: same floats as
            # the minimal trellis, O(S) work per section
            self.syn = [tail_syndrome_cols(kb, self.l, i)
                        if self.backend[i] == "trellis" else None
                        for i in range(self.l)]

    # ---- coset handling -------------------------------------------------

    def coset_signs(self, dec_g: torch.Tensor, i: int) -> torch.Tensor:
        """Sign flips from prior decisions: dec_g [l, P, n, B] gathered
        child decisions (rows >= i ignored) -> [P, l, n, B] of +-1.0."""
        x = self._xor_cols(dec_g, (1 << int(i)) - 1)
        return 1.0 - 2.0 * x.to(torch.float32)

    def _xor_cols(self, dec_g: torch.Tensor, rows: int) -> torch.Tensor:
        """[P, l, n, B] int8: column k = XOR of dec_g[j] over the rows j in
        the bit mask `rows` with K[j, k] = 1 (exact GF(2) product)."""
        zero = torch.zeros_like(dec_g[0], dtype=torch.int8)
        cols = []
        for k in range(self.l):
            acc = zero
            for j in range(self.l):
                if (rows >> j) & 1 and (self.kcol[k] >> j) & 1:
                    acc = acc ^ dec_g[j].to(torch.int8)
            cols.append(acc)
        return torch.stack(cols, dim=1)

    # ---- per-input LLR --------------------------------------------------

    def _maxcorr(self, lam_adj: torch.Tensor, i: int) -> torch.Tensor:
        """max over tail codewords of the correlation; lam_adj [.., l, n, B]."""
        t = torch.as_tensor(self.tables[i], device=lam_adj.device)
        out = None
        for c0, c1 in _chunks(lam_adj, t.shape[1]):
            mx = torch.amax(tree_corr(lam_adj, t[:, c0:c1]), dim=-3)
            out = mx if out is None else torch.maximum(out, mx)
        return out

    def _lsecorr(self, lam_adj: torch.Tensor, i: int) -> torch.Tensor:
        """logsumexp over tail codewords of correlation / 2 (the exact
        marginal's counterpart of _maxcorr); lam_adj [.., l, n, B]."""
        t = torch.as_tensor(self.tables[i], device=lam_adj.device)
        la = lam_adj.to(torch.float32)
        out = None
        for c0, c1 in _chunks(la, t.shape[1]):
            corr = 0.5 * torch.einsum("...lnb,lc->...cnb", la, t[:, c0:c1])
            lse = torch.logsumexp(corr, dim=-3)
            out = lse if out is None else torch.logaddexp(out, lse)
        return out

    def _llr_static(self, i: int, lam_adj: torch.Tensor) -> torch.Tensor:
        """Input-i LLR from coset-adjusted LLRs lam_adj [P, l, n, B]."""
        if self.l == 2:
            a, b = lam_adj[:, 0], lam_adj[:, 1]
            if i == 0:
                return (f_exact(a, b) if self.f_mode == "exact"
                        else f_minsum(a, b))
            return a + b  # g with u0 absorbed into the coset sign of a
        if i == self.l - 1:  # a single tail codeword: correlation with row i
            row = self.kernel[i].astype(np.float32).reshape(self.l, 1)
            return tree_corr(lam_adj, row)[..., 0, :, :]
        return self.plain_llr(i, lam_adj)

    def plain_llr(self, i: int, lam_adj: torch.Tensor) -> torch.Tensor:
        """The trellis/table input-i LLR (l > 2, i < l-1) in plain PyTorch:
        the CUDA stage kernel's plain version."""
        both = torch.stack(
            [lam_adj,
             lam_adj * torch.as_tensor(self.row_signs[i], device=lam_adj.device
                                       )[None, :, None, None]])
        if self.f_mode == "exact":
            lse = self._lsecorr(both, i)   # [2, P, n, B]
            return (lse[0] - lse[1]).to(lam_adj.dtype)
        if self.backend[i] == "trellis":
            from portbench.ref.trellis import syndrome_min_cost

            S, cols = self.syn[i]
            cost = syndrome_min_cost(S, cols, both)        # [2, P, n, B]
            return cost[1] - cost[0]
        corr = self._maxcorr(both, i)  # [2, P, n, B]
        return 0.5 * (corr[0] - corr[1])

    def fresh_llr(self, lam_view: torch.Tensor) -> torch.Tensor:
        """Input-0 LLR (new node, no prior decisions). lam_view [P,l,n,B]."""
        return self._llr_static(0, lam_view)

    def dynamic_llr(self, i, lam_view: torch.Tensor,
                    dec_g: torch.Tensor) -> torch.Tensor:
        """Input-i LLR; dec_g [l, P, n, B] prior decisions. The JAX
        package's traced-i form; here i is read on the host."""
        i = int(i)
        return self._llr_static(i, lam_view * self.coset_signs(dec_g, i))

    def static_llr(self, i: int, lam_view: torch.Tensor,
                   dec_g: torch.Tensor) -> torch.Tensor:
        """Input-i LLR; for the 2x2 kernel the coset collapses to the sign
        flip of the first output (g's u0 term)."""
        if self.l == 2 and i == 1:
            a = lam_view[:, 0] * (1.0 - 2.0 * dec_g[0].to(lam_view.dtype))
            return a + lam_view[:, 1]
        lam_adj = lam_view * self.coset_signs(dec_g, i)
        return self._llr_static(i, lam_adj)

    # ---- re-encode ------------------------------------------------------

    def reencode(self, dec_g: torch.Tensor) -> torch.Tensor:
        """Hard re-encode of a completed node: dec_g [l, P, n, B] child
        bits -> output block [P, l, n, B] int8 (x = u @ K mod 2)."""
        if self.l == 2:  # Arikan: x = (u0 ^ u1, u1)
            return torch.stack([dec_g[0] ^ dec_g[1], dec_g[1]], dim=1)
        return self._xor_cols(dec_g, (1 << self.l) - 1)
