"""Host-precomputed SC traversal schedule (SURVEY.md §7.0: "the per-bit
schedule ... is precomputed on host into index arrays and driven by
lax.fori_loop over the N leaf bits").

For leaf t with mixed-radix digits (d_1..d_m), t = sum_s d_s * n_s:

- s_star[t]: shallowest stage that computes a new kernel-input LLR before
  deciding leaf t (stage s_star computes input d_{s_star} of its current
  node; every deeper stage starts a fresh node with input 0).
- r_up[t]: number of completed nodes to hard re-encode after deciding
  leaf t (stages m, m-1, ..., m-r_up+1; stage 1's re-encode is skipped —
  nothing above consumes it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from polar_tpu_torch.models.polar import CodeSpec


@dataclasses.dataclass(frozen=True)
class Schedule:
    digits: np.ndarray   # [N, m] int32
    s_star: np.ndarray   # [N] int32, 1-based
    r_up: np.ndarray     # [N] int32, 0..m-1
    frozen: np.ndarray   # [N] int8


def build_schedule(spec: CodeSpec) -> Schedule:
    factors = spec.factors
    m = len(factors)
    n_sizes = spec.block_sizes  # n_0..n_m
    N = spec.N
    digits = np.zeros((N, m), dtype=np.int32)
    t = np.arange(N)
    rem = t.copy()
    for s in range(m):
        digits[:, s] = rem // n_sizes[s + 1]
        rem = rem % n_sizes[s + 1]
    s_star = np.zeros(N, dtype=np.int32)
    r_up = np.zeros(N, dtype=np.int32)
    for ti in range(N):
        d = digits[ti]
        tz = 0
        while tz < m and d[m - 1 - tz] == 0:
            tz += 1
        s_star[ti] = max(1, m - tz)
        tm = 0
        while tm < m and d[m - 1 - tm] == factors[m - 1 - tm] - 1:
            tm += 1
        r_up[ti] = min(tm, m - 1)
    return Schedule(digits=digits, s_star=s_star, r_up=r_up,
                    frozen=spec.frozen.astype(np.int8))
