"""ctypes bindings for the independent C++ golden codec
(csrc/polar_ref.cpp, a byte-for-byte copy of native/polar_ref.cpp).

The golden decoder is an independent C++ implementation of the documented
decoding conventions (SURVEY.md §2.3 knobs): min-sum marginals by brute
force over each kernel's tail codewords, path metrics summed in float64,
the bit-major stable 2L -> L sort and CRC-aided selection. It records the
golden files that the port's decoders replay (sim/golden.py). The library
is built with g++ at first use into build/ (ops/cuda_build.py
`build_host`); no g++ raises RuntimeError.
"""
from __future__ import annotations

import ctypes

import numpy as np

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops import cuda_build

SOURCE = "polar_ref.cpp"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(cuda_build.build_host(SOURCE)))
    lib.ref_create.restype = ctypes.c_void_p
    lib.ref_create.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_uint32]
    lib.ref_destroy.argtypes = [ctypes.c_void_p]
    lib.ref_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.ref_decode_scl.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return lib


class NativeGolden:
    """Handle to the C++ golden codec for one CodeSpec: `encode(u) -> x`
    and `decode(llrs, list_size) -> u` on numpy arrays."""

    def __init__(self, spec: CodeSpec):
        lib = _load()
        self.spec = spec
        m = len(spec.factors)
        factors = (ctypes.c_int * m)(*spec.factors)
        kflat = np.concatenate([k.reshape(-1) for k in spec.kernels]
                               ).astype(np.uint8)
        frozen = spec.frozen.astype(np.uint8)
        crc = spec.crc
        self._h = lib.ref_create(
            m, factors, kflat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frozen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            spec.N, spec.K,
            crc.width if crc else 0, crc.poly if crc else 0,
            crc.init if crc else 0)
        self._lib = lib

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ref_destroy(self._h)
            self._h = None

    def encode(self, u: np.ndarray) -> np.ndarray:
        u = np.ascontiguousarray(u.astype(np.uint8).reshape(-1, self.spec.N))
        out = np.empty_like(u)
        self._lib.ref_encode(
            self._h, u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            u.shape[0], out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out

    def decode(self, llrs: np.ndarray, list_size: int) -> np.ndarray:
        llrs = np.ascontiguousarray(
            llrs.astype(np.float64).reshape(-1, self.spec.N))
        out = np.empty((llrs.shape[0], self.spec.N), np.uint8)
        self._lib.ref_decode_scl(
            self._h, llrs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            llrs.shape[0], list_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
