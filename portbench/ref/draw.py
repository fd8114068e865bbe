"""The Monte-Carlo frame draw and error count, plain PyTorch: random data
bits -> CRC -> encode -> BPSK-AWGN -> LLRs, and the errors of decoded u.

A frozen copy of polar_tpu_torch/ops/mc.py's plain version (`mc_draw`,
`count_errors`), which the fused CUDA step repeats bit for bit.

The random stream (ops/philox.py) is the port's own: word w of codeword
b is output (w mod 4) of Philox4x32-10 under key `seed` = (seed0, seed1)
with counter (w div 4, b, 0, 0). Words [0, N) carry the candidate data
bit of row t in their least significant bit, words [N, 3N/2) the
uniforms u1 and [3N/2, 2N) the uniforms u2 of a Box-Muller draw whose
cos half fills rows [0, N/2) and sin half rows [N/2, N), as the TPU
kernel does (pallas_scl.py:457-543).

Errors count on the data rows only (info_positions[:K]): CRC rows do not
count, and a frame error is at least one bit error.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.ref.polar import CodeSpec
from portbench.ref.crc import crc_append
from portbench.ref.encode import assemble_u, encode_u
from portbench.ref.philox import random_words

TWO_PI = float(np.float32(2.0 * np.pi))     # float32(2 pi), exact as a double
TWO_M24 = 2.0 ** -24


def mc_frames(spec: CodeSpec, seed: tuple[int, int], batch: int, device=None):
    """The frames of one step: (u_true [B, N] int8, x [B, N] int8, gauss
    [B, N] float32 standard normals)."""
    N, K = spec.N, spec.K
    w = random_words(seed, batch, 2 * N, device)
    data_rows = torch.as_tensor(spec.info_positions[:K], device=w.device)
    info = (w[:, data_rows] & 1).to(torch.int8)                   # [B, K]
    payload = crc_append(spec.crc, info) if spec.crc is not None else info
    u_true = assemble_u(spec, payload)
    x = encode_u(spec, u_true)
    return u_true, x, box_muller(w[:, N:])


def box_muller(w: torch.Tensor) -> torch.Tensor:
    """[B, n] float32 standard normals from [B, n] 32-bit words (n even):
    words [0, n/2) give the uniforms u1, words [n/2, n) the uniforms u2,
    the cos half fills columns [0, n/2) and the sin half [n/2, n)."""
    nh = w.shape[1] // 2
    u1 = ((w[:, :nh] >> 8).to(torch.float32) + 1.0) * TWO_M24        # (0, 1]
    u2 = (w[:, nh:] >> 8).to(torch.float32) * TWO_M24                # [0, 1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = u2 * TWO_PI
    return torch.cat([r * torch.cos(th), r * torch.sin(th)], dim=1)


def mc_channel(x: torch.Tensor, gauss: torch.Tensor, sigma) -> torch.Tensor:
    """llr = (2 / (sigma * sigma)) * ((1 - 2x) + sigma * gauss) in
    float32, the kernel's expression order (not sim/channel.llr_demod's
    2y / sigma^2, which rounds differently)."""
    sg = torch.tensor(np.float32(sigma))       # a 0-d CPU scalar
    y = (1.0 - 2.0 * x.to(torch.float32)) + sg * gauss
    return (2.0 / (sg * sg)) * y


def mc_draw(spec: CodeSpec, seed: tuple[int, int], sigma, batch: int,
            device=None, noise: torch.Tensor | None = None):
    """(u_true [B, N] int8, llr [B, N] float32) of one step in plain
    PyTorch on `device`. `noise` [B, N] standard normals, if given, takes
    the place of the Box-Muller draw."""
    u_true, x, gauss = mc_frames(spec, seed, batch, device)
    if noise is not None:
        gauss = noise.to(device=x.device, dtype=torch.float32)
    return u_true, mc_channel(x, gauss, sigma)


def count_errors(spec: CodeSpec, u: torch.Tensor, u_true: torch.Tensor):
    """[2, B] int32: frame error (0/1) and bit errors of each codeword on
    the data rows."""
    data = torch.zeros(spec.N, dtype=torch.bool, device=u.device)
    data[torch.as_tensor(spec.info_positions[:spec.K], device=u.device)] = True
    bits = ((u != u_true) & data).sum(dim=1, dtype=torch.int32)
    return torch.stack([(bits > 0).to(torch.int32), bits])
