"""Batched multi-kernel polar encoder (PyTorch).

Counterpart of polar_tpu/ops/encode.py: each kernel factor is applied as
a tensordot along its own axis of the [B, l_1, ..., l_m] reshape.

x = u · (K_1 ⊗ ... ⊗ K_m) mod 2, position index p = sum_s a_s * n_s.
The products run in float64 (exact for 0/1 sums of at most l terms).
"""
from __future__ import annotations

import torch

from polar_tpu_torch.models.polar import CodeSpec


def encode_u(spec: CodeSpec, u: torch.Tensor) -> torch.Tensor:
    """Apply the full Kronecker transform to u-vectors.

    u: [..., N] int (0/1). Returns codewords x: [..., N] int8.
    """
    factors = spec.factors
    batch_shape = tuple(u.shape[:-1])
    t = u.reshape(*batch_shape, *factors).to(torch.float64)
    nb = len(batch_shape)
    for s in range(len(factors)):
        k = torch.as_tensor(spec.kernels[s], device=u.device,
                            dtype=torch.float64)
        axis = nb + s
        t = torch.tensordot(t, k, dims=([axis], [0]))
        t = torch.movedim(t, -1, axis)
    x = torch.remainder(t, 2.0)
    return x.reshape(*batch_shape, spec.N).to(torch.int8)


def _positions(spec: CodeSpec, device) -> torch.Tensor:
    return torch.as_tensor(spec.info_positions, device=device)


def assemble_u(spec: CodeSpec, payload: torch.Tensor) -> torch.Tensor:
    """Scatter payload bits (info + CRC, already concatenated in slot order)
    into unfrozen positions; zeros at frozen positions.

    payload: [..., K + n_crc] -> u: [..., N] int8
    """
    u = torch.zeros(*payload.shape[:-1], spec.N, dtype=torch.int8,
                    device=payload.device)
    u[..., _positions(spec, payload.device)] = payload.to(torch.int8)
    return u


def encode(spec: CodeSpec, payload: torch.Tensor) -> torch.Tensor:
    """payload (info+CRC bits) -> codeword x [..., N]."""
    return encode_u(spec, assemble_u(spec, payload))


def extract_payload(spec: CodeSpec, u: torch.Tensor) -> torch.Tensor:
    """Gather unfrozen positions of u: inverse of assemble_u."""
    return u[..., _positions(spec, u.device)]
