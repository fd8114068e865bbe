"""Polar code specification: (N, K, kernel factors, frozen set, CRC).

TPU-native analogue of the reference's C++ `PolarCode` object (SURVEY.md
C6/C7 context; reference mount empty, §0). A `CodeSpec` is a *static*,
hashable description; all device arrays derived from it are precomputed on
the host so jitted functions close over them as constants.

Kernel factor convention: x = u · (K_1 ⊗ K_2 ⊗ ... ⊗ K_m), factors[s] is
the kernel at stage s+1 (outermost first). Leaf/bit index
t = sum_s d_s * n_s with n_s = N / (l_1 ... l_s).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from portbench.ref.bch import ARIKAN_KERNEL, build_bch_kernel


def kernel_matrix(l: int) -> np.ndarray:
    if l == 2:
        return ARIKAN_KERNEL.copy()
    return build_bch_kernel(l)


@dataclasses.dataclass(frozen=True)
class CrcSpec:
    """CRC appended to the info bits (SURVEY.md C10; BASELINE.json:8).

    Default: CRC-16-CCITT polynomial 0x1021, init 0, no reflection — the
    common convention in the polar-coding literature. All three are explicit
    bit-match knobs (SURVEY.md §2.3 item 1).
    """

    width: int = 16
    poly: int = 0x1021
    init: int = 0x0000

    def compute(self, bits: np.ndarray) -> np.ndarray:
        """Bitwise host CRC over a 1-D bit array (MSB-first). Returns width bits."""
        reg = self.init
        top = 1 << (self.width - 1)
        mask = (1 << self.width) - 1
        for b in np.asarray(bits, dtype=np.int64) & 1:
            fb = ((reg >> (self.width - 1)) & 1) ^ int(b)
            reg = ((reg << 1) & mask) ^ (self.poly if fb else 0)
        return ((reg >> np.arange(self.width - 1, -1, -1)) & 1).astype(np.uint8)

    @cached_property
    def matrix_cache(self):
        return {}

    def generator_matrix(self, n_info: int) -> np.ndarray:
        """G such that crc_bits = (info @ G) mod 2  for MSB-first info bits.

        CRC is linear with init=0; for init != 0 the affine offset is the CRC
        of the zero message, handled by callers via `offset_bits`.
        """
        if n_info in self.matrix_cache:
            return self.matrix_cache[n_info]
        base = CrcSpec(self.width, self.poly, 0)
        g = np.zeros((n_info, self.width), dtype=np.uint8)
        for i in range(n_info):
            e = np.zeros(n_info, dtype=np.uint8)
            e[i] = 1
            g[i] = base.compute(e)
        self.matrix_cache[n_info] = g
        return g

    def offset_bits(self, n_info: int) -> np.ndarray:
        """CRC of the all-zero message (nonzero iff init != 0)."""
        return self.compute(np.zeros(n_info, dtype=np.uint8))


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Static description of a (mixed-kernel) polar code."""

    N: int
    K: int                       # number of payload info bits (excl. CRC)
    factors: tuple[int, ...]     # kernel sizes, outermost first
    frozen_mask: tuple[int, ...] # length N, 1 = frozen
    crc: CrcSpec | None = None

    def __post_init__(self):
        prod = int(np.prod(self.factors))
        if prod != self.N:
            raise ValueError(f"prod(factors)={prod} != N={self.N}")
        if len(self.frozen_mask) != self.N:
            raise ValueError("frozen_mask length != N")
        n_unfrozen = self.N - int(sum(self.frozen_mask))
        if n_unfrozen != self.n_payload_slots:
            raise ValueError(
                f"unfrozen slots {n_unfrozen} != K + crc = {self.n_payload_slots}"
            )

    @property
    def n_crc(self) -> int:
        return self.crc.width if self.crc is not None else 0

    @property
    def n_payload_slots(self) -> int:
        """Unfrozen slot count: K info bits + CRC bits."""
        return self.K + self.n_crc

    @property
    def rate(self) -> float:
        return self.K / self.N

    @cached_property
    def frozen(self) -> np.ndarray:
        return np.array(self.frozen_mask, dtype=np.uint8)

    @cached_property
    def info_positions(self) -> np.ndarray:
        """Indices of unfrozen u-slots in increasing order (info then CRC by
        position order — info+CRC are placed jointly in slot order)."""
        return np.nonzero(1 - self.frozen)[0].astype(np.int64)

    @cached_property
    def kernels(self) -> tuple[np.ndarray, ...]:
        return tuple(kernel_matrix(l) for l in self.factors)

    @cached_property
    def block_sizes(self) -> tuple[int, ...]:
        """n_s for s = 0..m: n_0 = N, n_s = n_{s-1} / l_s, n_m = 1."""
        out = [self.N]
        for l in self.factors:
            out.append(out[-1] // l)
        return tuple(out)

    @cached_property
    def generator(self) -> np.ndarray:
        """Full N x N transform G = K_1 ⊗ ... ⊗ K_m over GF(2) (small-N only;
        tests and the numpy oracle use it — the device encoder is staged)."""
        from portbench.ref.gf2 import gf2_kron

        g = np.array([[1]], dtype=np.uint8)
        for k in self.kernels:
            g = gf2_kron(g, k)
        return g


def spec_from_reference(obj) -> CodeSpec:
    """Build this package's `CodeSpec` from any object that carries a code
    specification: an object with `factors`, `frozen_mask` (or `frozen`),
    `K` and `crc` (None or width/poly/init) attributes, such as the JAX
    package's `CodeSpec`; or a mapping with the golden-record keys
    `factors`, `frozen`, `K`, `crc_width`, `crc_poly`, `crc_init`, such as
    an opened `.npz` record (a zero `crc_width` means no CRC)."""
    if hasattr(obj, "keys") and "crc_width" in obj.keys():
        factors = obj["factors"]
        frozen = obj["frozen"]
        K = obj["K"]
        width = int(obj["crc_width"])
        crc = (CrcSpec(width=width, poly=int(obj["crc_poly"]),
                       init=int(obj["crc_init"])) if width else None)
    else:
        factors = obj.factors
        frozen = getattr(obj, "frozen_mask", None)
        if frozen is None:
            frozen = obj.frozen
        K = obj.K
        ref_crc = obj.crc
        crc = (None if ref_crc is None else
               CrcSpec(width=int(ref_crc.width), poly=int(ref_crc.poly),
                       init=int(ref_crc.init)))
    frozen = tuple(int(v) for v in np.asarray(frozen).reshape(-1))
    return CodeSpec(N=len(frozen), K=int(K),
                    factors=tuple(int(f) for f in np.asarray(factors).reshape(-1)),
                    frozen_mask=frozen, crc=crc)
