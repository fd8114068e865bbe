"""GF(2^m) arithmetic tables for BCH generator construction.

TPU-native equivalent of the reference's C++ finite-field layer
(SURVEY.md C2: log/antilog tables, minimal polynomials; mount empty, §0).
Host-side only — consumed by `polar_tpu.kernels.bch` at construction time.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# Standard primitive polynomials over GF(2), bit i = coefficient of x^i.
PRIMITIVE_POLYS = {
    2: 0b111,          # x^2 + x + 1
    3: 0b1011,         # x^3 + x + 1
    4: 0b10011,        # x^4 + x + 1
    5: 0b100101,       # x^5 + x^2 + 1
    6: 0b1000011,      # x^6 + x + 1
    7: 0b10001001,     # x^7 + x^3 + 1
    8: 0b100011101,    # x^8 + x^4 + x^3 + x^2 + 1
}


class GF2m:
    """GF(2^m) via log/antilog tables built from a primitive polynomial."""

    def __init__(self, m: int, prim_poly: int | None = None):
        if prim_poly is None:
            prim_poly = PRIMITIVE_POLYS[m]
        self.m = m
        self.q = 1 << m
        self.prim_poly = prim_poly
        exp = np.zeros(2 * self.q, dtype=np.int64)
        log = np.zeros(self.q, dtype=np.int64)
        x = 1
        for i in range(self.q - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.q:
                x ^= prim_poly
        if x != 1:
            raise ValueError(f"poly {prim_poly:#x} is not primitive for m={m}")
        # Duplicate for mod-free exponent addition.
        exp[self.q - 1 : 2 * (self.q - 1)] = exp[: self.q - 1]
        self.exp = exp
        self.log = log

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def pow_alpha(self, e: int) -> int:
        """alpha^e (alpha = primitive element)."""
        return int(self.exp[e % (self.q - 1)])

    def conjugacy_class(self, e: int) -> list[int]:
        """Exponents {e, 2e, 4e, ...} mod (q-1) — the conjugates of alpha^e."""
        n = self.q - 1
        out = []
        c = e % n
        while c not in out:
            out.append(c)
            c = (2 * c) % n
        return out

    @lru_cache(maxsize=None)
    def minimal_polynomial(self, e: int) -> int:
        """Minimal polynomial of alpha^e over GF(2), as a bitmask poly.

        prod over conjugates c of (x + alpha^c), coefficients reduced to GF(2)
        (they land in GF(2) automatically).
        """
        # Polynomial with coefficients in GF(2^m): list low→high degree.
        poly = [1]
        for c in self.conjugacy_class(e):
            root = self.pow_alpha(c)
            # poly *= (x + root)
            new = [0] * (len(poly) + 1)
            for i, coef in enumerate(poly):
                new[i + 1] ^= coef               # x * coef
                new[i] ^= self.mul(coef, root)   # root * coef
            poly = new
        mask = 0
        for i, coef in enumerate(poly):
            if coef not in (0, 1):
                raise AssertionError("minimal polynomial not over GF(2)")
            mask |= coef << i
        return mask


def poly_mul_gf2(a: int, b: int) -> int:
    """Multiply two GF(2)[x] polynomials given as bitmasks."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        b >>= 1
    return out


def poly_lcm_gf2(polys: list[int]) -> int:
    """LCM of GF(2)[x] polynomials (bitmasks)."""
    out = 1
    for p in polys:
        g = poly_gcd_gf2(out, p)
        out = poly_mul_gf2(out // 1, 0) if False else poly_mul_gf2(out, p)
        out = poly_div_gf2(out, g)[0]
    return out


def poly_divmod_bits(a: int, b: int) -> tuple[int, int]:
    """Divide GF(2)[x] polynomial a by b: returns (quotient, remainder)."""
    if b == 0:
        raise ZeroDivisionError
    db = b.bit_length() - 1
    q = 0
    while a.bit_length() - 1 >= db and a:
        shift = (a.bit_length() - 1) - db
        q ^= 1 << shift
        a ^= b << shift
    return q, a


def poly_div_gf2(a: int, b: int) -> tuple[int, int]:
    return poly_divmod_bits(a, b)


def poly_gcd_gf2(a: int, b: int) -> int:
    while b:
        a, b = b, poly_divmod_bits(a, b)[1]
    return a
