"""Frozen-set construction via Gaussian approximation (Arikan kernels).

TPU-native equivalent of the reference's code-construction layer
(SURVEY.md C6/L3; exact reference method unknown — mount empty, §0 — so
the method is an explicit, tested config knob per SURVEY.md §2.3 item 2).

Standard GA density evolution (Trifonov 2012 / Chung et al. phi function):
under the all-zero codeword, leaf LLRs are approximated as Gaussians
N(m, 2m); the check (f) update maps means via phi, the variable (g)
update doubles the mean. Reliability ordering = leaf means; freeze the
N-K(+crc) least reliable. Pure host-side numpy.
"""
from __future__ import annotations

import numpy as np


def _phi(x: np.ndarray) -> np.ndarray:
    """E[tanh(L/2)] proxy for L ~ N(x, 2x) (Chung's approximation)."""
    x = np.asarray(x, dtype=np.float64)
    small = np.exp(-0.4527 * np.power(np.maximum(x, 1e-12), 0.859) + 0.0218)
    big = np.sqrt(np.pi / np.maximum(x, 1e-12)) * np.exp(-x / 4.0) * (
        1.0 - 10.0 / (7.0 * np.maximum(x, 1e-12)))
    return np.where(x < 10.0, small, big)


def _phi_inv(y: np.ndarray) -> np.ndarray:
    """Numerical inverse of _phi via bisection on [1e-12, 1e4]."""
    y = np.asarray(y, dtype=np.float64)
    lo = np.full_like(y, 1e-12)
    hi = np.full_like(y, 1e4)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        too_big = _phi(mid) > y  # phi decreasing: phi(mid) > y -> mid too small
        lo = np.where(too_big, mid, lo)
        hi = np.where(too_big, hi, mid)
    return 0.5 * (lo + hi)


def ga_leaf_means(n_stages: int, design_llr_mean: float) -> np.ndarray:
    """Leaf LLR means for a 2^n Arikan code, natural leaf order."""
    m = np.array([design_llr_mean], dtype=np.float64)
    for _ in range(n_stages):
        f = _phi_inv(1.0 - (1.0 - _phi(m)) ** 2)   # check node (input 0)
        g = 2.0 * m                                # variable node (input 1)
        m = np.stack([f, g], axis=1).reshape(-1)   # leaf order: f first
    return m


def construct_ga(N: int, n_unfrozen: int, design_ebn0_db: float,
                 rate: float | None = None) -> np.ndarray:
    """Frozen mask (1 = frozen) for a pure-Arikan code via GA.

    design LLR mean = 2/sigma^2 = 4 * R * 10^(EbN0/10) with R defaulting to
    n_unfrozen / N (payload + CRC all count as unfrozen slots).
    """
    n_stages = int(np.log2(N))
    if 1 << n_stages != N:
        raise ValueError("GA construction requires N = 2^m (Arikan kernels)")
    r = rate if rate is not None else n_unfrozen / N
    mean0 = 4.0 * r * 10.0 ** (design_ebn0_db / 10.0)
    means = ga_leaf_means(n_stages, mean0)
    # most reliable n_unfrozen leaves are unfrozen; stable order tie-break
    order = np.argsort(-means, kind="stable")
    frozen = np.ones(N, dtype=np.uint8)
    frozen[order[:n_unfrozen]] = 0
    return frozen
