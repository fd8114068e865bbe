"""GF(2) linear algebra on the host (numpy).

TPU-native equivalent of the reference's C++ GF(2) utilities
(SURVEY.md C1: kron / gf2_matmul / bit helpers; reference mount empty, see
SURVEY.md §0 — capability surface from BASELINE.json:5).

All of this runs at *construction time* on the host; the on-device mod-2
transforms live in `polar_tpu.ops.encode` as batched XLA ops.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "gf2_matmul",
    "gf2_kron",
    "gf2_rank",
    "gf2_rref",
    "gf2_inverse",
    "gf2_row_space_contains",
    "gf2_null_space",
    "min_weight",
    "coset_min_weight",
]


def _as_gf2(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.int64) & 1
    return a.astype(np.uint8)


def gf2_matmul(a, b) -> np.ndarray:
    """(a @ b) mod 2 for binary matrices."""
    a = _as_gf2(a)
    b = _as_gf2(b)
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


def gf2_kron(a, b) -> np.ndarray:
    """Kronecker product over GF(2)."""
    return (np.kron(_as_gf2(a), _as_gf2(b)) & 1).astype(np.uint8)


def gf2_rref(a) -> tuple[np.ndarray, list[int]]:
    """Reduced row-echelon form over GF(2). Returns (rref, pivot_cols)."""
    m = _as_gf2(a).copy()
    rows, cols = m.shape
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivot_rows = np.nonzero(m[r:, c])[0]
        if pivot_rows.size == 0:
            continue
        pr = r + pivot_rows[0]
        if pr != r:
            m[[r, pr]] = m[[pr, r]]
        # Eliminate this column from every other row.
        hit = np.nonzero(m[:, c])[0]
        hit = hit[hit != r]
        m[hit] ^= m[r]
        pivots.append(c)
        r += 1
    return m, pivots


def gf2_rank(a) -> int:
    _, pivots = gf2_rref(a)
    return len(pivots)


def gf2_inverse(a) -> np.ndarray:
    """Inverse of a square binary matrix over GF(2). Raises if singular."""
    a = _as_gf2(a)
    n = a.shape[0]
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    rref, pivots = gf2_rref(aug)
    if pivots[:n] != list(range(n)):
        raise ValueError("matrix is singular over GF(2)")
    return rref[:, n:]


def gf2_row_space_contains(basis, v) -> bool:
    """True if vector v lies in the GF(2) row space of `basis`."""
    basis = _as_gf2(basis)
    v = _as_gf2(v).reshape(1, -1)
    if basis.size == 0:
        return not v.any()
    return gf2_rank(basis) == gf2_rank(np.concatenate([basis, v], axis=0))


def gf2_null_space(a) -> np.ndarray:
    """Basis (rows) of the right null space {x : a @ x = 0} over GF(2)."""
    a = _as_gf2(a)
    _, cols = a.shape
    rref, pivots = gf2_rref(a)
    free = [c for c in range(cols) if c not in pivots]
    basis = []
    for f in free:
        x = np.zeros(cols, dtype=np.uint8)
        x[f] = 1
        for r, p in enumerate(pivots):
            x[p] = rref[r, f]
        basis.append(x)
    return np.array(basis, dtype=np.uint8).reshape(len(basis), cols)


def _all_codewords(basis: np.ndarray) -> np.ndarray:
    """Enumerate all 2^k codewords of the row space (k small)."""
    basis = _as_gf2(basis)
    k, n = basis.shape
    if k == 0:
        return np.zeros((1, n), dtype=np.uint8)
    if k > 20:
        raise ValueError(f"refusing to enumerate 2^{k} codewords")
    msgs = ((np.arange(1 << k)[:, None] >> np.arange(k)[None, :]) & 1).astype(np.uint8)
    return gf2_matmul(msgs, basis)


def min_weight(basis) -> int:
    """Minimum nonzero Hamming weight of the code spanned by `basis` rows."""
    cw = _all_codewords(basis)
    w = cw.sum(axis=1)
    nz = w[w > 0]
    return int(nz.min()) if nz.size else 0


def coset_min_weight(offset, basis) -> int:
    """Minimum Hamming weight over the coset offset + rowspace(basis)."""
    cw = _all_codewords(basis) ^ _as_gf2(offset)[None, :]
    return int(cw.sum(axis=1).min())
