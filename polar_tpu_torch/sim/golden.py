"""Golden-file records: hard decisions of the independent C++ decoder on
fixed channel LLRs, replayed through this package's decoders (which must
reproduce them frame for frame).

Record format (.npz):
    factors[int m], frozen[uint8 N], K, crc_width, crc_poly, crc_init,
    list_size, llrs[float64 B, N], u_ref[uint8 B, N]

Only the reader is here; records are written by the JAX package's
recorder (`scripts/flagship_golden.py`).
"""
from __future__ import annotations

import pathlib

import numpy as np

from polar_tpu_torch.models.polar import CodeSpec, CrcSpec


def load_golden(path: str | pathlib.Path):
    """-> (spec, list_size, llrs, u_ref)"""
    z = np.load(path)
    crc = None
    if int(z["crc_width"]):
        crc = CrcSpec(width=int(z["crc_width"]), poly=int(z["crc_poly"]),
                      init=int(z["crc_init"]))
    spec = CodeSpec(
        N=int(z["frozen"].size), K=int(z["K"]),
        factors=tuple(int(f) for f in z["factors"]),
        frozen_mask=tuple(int(v) for v in z["frozen"]), crc=crc)
    return spec, int(z["list_size"]), z["llrs"], z["u_ref"]
