"""Batched CRC append/check over GF(2) (PyTorch).

Counterpart of polar_tpu/ops/crc.py. The CRC is a linear map over GF(2):
one [..., K] @ [K, width] product, then mod 2, plus an affine offset when
init != 0. The product runs in float64: its sums (at most K) are exact
there, and no float64 product goes through TF32 on the card.
"""
from __future__ import annotations

import torch

from polar_tpu_torch.models.polar import CrcSpec


def _crc_bits(crc: CrcSpec, info: torch.Tensor) -> torch.Tensor:
    k = info.shape[-1]
    g = torch.as_tensor(crc.generator_matrix(k), device=info.device,
                        dtype=torch.float64)
    off = torch.as_tensor(crc.offset_bits(k), device=info.device,
                          dtype=torch.float64)
    return torch.remainder(info.to(torch.float64) @ g + off, 2.0).to(torch.int8)


def crc_append(crc: CrcSpec, info: torch.Tensor) -> torch.Tensor:
    """info [..., K] -> [..., K + width] int8 with CRC bits appended."""
    return torch.cat([info.to(torch.int8), _crc_bits(crc, info)], dim=-1)


def crc_check(crc: CrcSpec, payload: torch.Tensor) -> torch.Tensor:
    """payload [..., K + width] (info ++ crc) -> bool [...]: True if CRC ok."""
    k = payload.shape[-1] - crc.width
    bits = _crc_bits(crc, payload[..., :k])
    return torch.all(bits == payload[..., k:].to(torch.int8), dim=-1)
