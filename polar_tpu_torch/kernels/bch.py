"""Extended-BCH polarization kernel builder.

TPU-native equivalent of the reference's C++ BCH-kernel construction
(SURVEY.md C3: rows drawn from a nested chain of extended-BCH subcodes,
yielding a partial-distance profile that beats Arikan's polarization
exponent — BASELINE.json:5,9; reference mount empty, SURVEY.md §0).

For l = 16 the chain is
    F^16 ⊃ eBCH[16,15,2] ⊃ eBCH[16,11,4] ⊃ eBCH[16,7,6]
         ⊃ eBCH[16,5,8] ⊃ eRep[16,1,16]
and the kernel's partial-distance profile is
    (1,2,2,2,2,4,4,4,4,6,6,8,8,8,8,16)
(validated exactly in tests/test_kernels.py by brute-force coset search).

Everything here is host-side numpy, run once at code-construction time.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from polar_tpu_torch.utils.gf2 import gf2_rank, gf2_rref
from polar_tpu_torch.utils.gf2m import GF2m, poly_div_gf2, poly_mul_gf2

ARIKAN_KERNEL = np.array([[1, 0], [1, 1]], dtype=np.uint8)


def _bch_generator_poly(field: GF2m, designed_distance: int) -> int:
    """Generator polynomial (bitmask) of the narrow-sense BCH code of
    length 2^m - 1 with the given designed distance."""
    g = 1
    for e in range(1, designed_distance):
        mp = field.minimal_polynomial(e)
        # mp is irreducible, so lcm(g, mp) = g * mp unless mp already divides g.
        if poly_div_gf2(g, mp)[1] != 0:
            g = poly_mul_gf2(g, mp)
    return g


def _cyclic_generator_matrix(g: int, n: int) -> np.ndarray:
    """Rows = x^i * g(x) mod (x^n - 1) ... for cyclic codes deg shifts suffice:
    k = n - deg(g), rows are plain shifts (no wraparound needed)."""
    deg = g.bit_length() - 1
    k = n - deg
    rows = np.zeros((k, n), dtype=np.uint8)
    for i in range(k):
        shifted = g << i
        for j in range(n):
            rows[i, j] = (shifted >> j) & 1
    return rows


def _extend_parity(gen: np.ndarray) -> np.ndarray:
    """Append an overall even-parity bit to every generator row."""
    parity = gen.sum(axis=1, keepdims=True) & 1
    return np.concatenate([gen, parity], axis=1).astype(np.uint8)


def ebch_chain(l: int) -> list[np.ndarray]:
    """Nested chain of codes of length l = 2^m, largest first.

    Returns generator matrices [G_0, G_1, ...] with rowspace(G_0) = F^l and
    each subsequent a strict subcode: extended BCH codes of increasing
    designed distance, ending with the repetition code.
    """
    m = int(np.log2(l))
    if 1 << m != l:
        raise ValueError("kernel size must be a power of two")
    if l == 2:
        return [np.eye(2, dtype=np.uint8), np.array([[1, 1]], dtype=np.uint8)]
    field = GF2m(m)
    n = l - 1
    chain = [np.eye(l, dtype=np.uint8)]
    # The extension of the trivial [n, n, 1] code: the [l, l-1, 2] SPC
    # (all even-weight vectors) — first proper member of the eBCH chain.
    chain.append(_extend_parity(np.eye(n, dtype=np.uint8)))
    seen_dims = {l, l - 1}
    for d in range(2, n + 1):
        g = _bch_generator_poly(field, d)
        k = n - (g.bit_length() - 1)
        if k <= 0:
            break
        ext = _extend_parity(_cyclic_generator_matrix(g, n))
        if ext.shape[0] in seen_dims:
            continue
        seen_dims.add(ext.shape[0])
        chain.append(ext)
    # Repetition code [l, 1, l].
    if 1 not in seen_dims:
        chain.append(np.ones((1, l), dtype=np.uint8))
    return chain


@lru_cache(maxsize=None)
def _bch_kernel_cached(l: int) -> bytes:
    return build_bch_kernel_impl(l).tobytes()


def build_bch_kernel(l: int = 16) -> np.ndarray:
    """l x l extended-BCH polarization kernel (deterministic).

    Row i is chosen so rows i..l-1 span the smallest chain code of dimension
    >= l - i; the partial distance of row i is the minimum weight of the
    coset row_i + span(rows i+1..l-1).
    """
    if l == 2:
        return ARIKAN_KERNEL.copy()
    return np.frombuffer(_bch_kernel_cached(l), dtype=np.uint8).reshape(l, l).copy()


def build_bch_kernel_impl(l: int) -> np.ndarray:
    chain = ebch_chain(l)  # largest code first
    # Build rows bottom-up: start from the smallest code, extend span upward.
    rows: list[np.ndarray] = []
    current: np.ndarray = np.zeros((0, l), dtype=np.uint8)
    for gen in reversed(chain):
        for cand in gen:  # deterministic order: generator rows as constructed
            if current.shape[0] and gf2_rank(np.vstack([current, cand])) == current.shape[0]:
                continue
            if current.shape[0] == 0 and not cand.any():
                continue
            rows.append(cand.copy())
            current = np.vstack([current, cand]) if current.size else cand.reshape(1, -1)
        # after consuming this chain code, span == that code's rowspace
    kernel = np.array(list(reversed(rows)), dtype=np.uint8)
    assert kernel.shape == (l, l) and gf2_rank(kernel) == l
    return kernel


def partial_distances(kernel: np.ndarray) -> list[int]:
    """Exact partial distances via brute-force coset minimum-weight search."""
    from polar_tpu_torch.utils.gf2 import coset_min_weight

    l = kernel.shape[0]
    out = []
    for i in range(l):
        out.append(coset_min_weight(kernel[i], kernel[i + 1 :]))
    return out
