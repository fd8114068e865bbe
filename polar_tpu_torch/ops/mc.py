"""The fused Monte-Carlo step: random data bits -> CRC -> encode ->
BPSK-AWGN -> LLRs -> CA-SCL decode -> error counts.

Counterpart of polar_tpu/ops/pallas_scl.py build_pallas_mc_step, for
every spec the decoder takes (Arikan, eBCH and mixed kernels). On the
card the whole step is one kernel launch per batch (csrc/scl_decode.cu:
scl_mc_traj in full mode, scl_mc_counters in counters mode; the encode is
stagewise Kronecker there); `mc_draw` followed by the plain decoder
(ops/scl.py) is its plain version, and the CPU runs it.

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

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops.crc import crc_append
from polar_tpu_torch.ops.cuda_scl import (SclDecoder, trajectory_layout,
                                          trajectory_outputs)
from polar_tpu_torch.ops.encode import assemble_u, encode_u
from polar_tpu_torch.ops.philox import MASK32, random_words
from polar_tpu_torch.utils.device import resolve_device

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


def _check_seed(seed) -> tuple[int, int]:
    s0, s1 = (int(v) for v in seed)
    if not (0 <= s0 <= MASK32 and 0 <= s1 <= MASK32):
        raise ValueError(f"seed words {seed} must be 32-bit")
    return s0, s1


class McStep:
    """step(seed (seed0, seed1), sigma, batch, noise=None) ->
    (frame_errors, bit_errors, u_true [B, N], DecodeResult), or
    (frame_errors, bit_errors, None, None) in counters mode.

    `kernel` (== calling the step) runs the step's kernel on a CUDA
    device and the plain version on the CPU; `plain` is the plain version
    on the step's device. `counts` / `trajectory` give the per-codeword
    outputs of the counters / full-mode kernel, `plain_counts` /
    `plain_trajectory` those of the plain version."""

    def __init__(self, spec: CodeSpec, list_size: int, device="cuda",
                 counters: bool = False):
        self.spec = spec
        self.P = int(list_size)
        self.device = resolve_device(device)
        self.counters = bool(counters)
        self.decoder = SclDecoder(spec, self.P, self.device)

    def __call__(self, seed, sigma, batch: int, noise=None):
        return self.kernel(seed, sigma, batch, noise)

    def kernel(self, seed, sigma, batch: int, noise=None):
        if self.device.type == "cpu":
            return self.plain(seed, sigma, batch, noise)
        if self.counters:
            cnt = self.counts(seed, sigma, batch, noise)
            return cnt[0].sum(), cnt[1].sum(), None, None
        traj_bit, traj_perm, pm, u_true = self.trajectory(seed, sigma, batch,
                                                          noise)
        res = self.decoder.epilogue(traj_bit, traj_perm, pm)
        cnt = count_errors(self.spec, res.u, u_true)
        return cnt[0].sum(), cnt[1].sum(), u_true, res

    def plain(self, seed, sigma, batch: int, noise=None):
        u_true, llr = self._draw(seed, sigma, batch, noise)
        res = self.decoder.plain(llr)
        cnt = count_errors(self.spec, res.u, u_true)
        if self.counters:
            return cnt[0].sum(), cnt[1].sum(), None, None
        return cnt[0].sum(), cnt[1].sum(), u_true, res

    def counts(self, seed, sigma, batch: int, noise=None) -> torch.Tensor:
        """[2, B] int32 per-codeword frame error and bit errors:
        scl_mc_counters on a CUDA device, the plain version on the CPU."""
        if self.device.type == "cpu":
            return self.plain_counts(seed, sigma, batch, noise)
        cnt = torch.empty((2, batch), dtype=torch.int32, device=self.device)
        self._launch("scl_mc_counters", seed, sigma, batch, noise,
                     counters=cnt)
        return cnt

    def plain_counts(self, seed, sigma, batch: int, noise=None) -> torch.Tensor:
        u_true, llr = self._draw(seed, sigma, batch, noise)
        return count_errors(self.spec, self.decoder.plain(llr).u, u_true)

    def trajectory(self, seed, sigma, batch: int, noise=None):
        """(traj_bit [N, P, B] int8, traj_perm [Q, P, B] int64, pm [P, B],
        u_true [B, N] int8): scl_mc_traj on a CUDA device, the plain
        version on the CPU."""
        if self.device.type == "cpu":
            return self.plain_trajectory(seed, sigma, batch, noise)
        out = trajectory_outputs(self.spec, self.P, len(self.decoder.spans),
                                 batch, self.device, mc=True)
        self._launch("scl_mc_traj", seed, sigma, batch, noise, **out)
        return (*trajectory_layout(out), out["u_true"])

    def plain_trajectory(self, seed, sigma, batch: int, noise=None):
        u_true, llr = self._draw(seed, sigma, batch, noise)
        return (*self.decoder.plain_trajectory(llr), u_true)

    def _check_noise(self, noise, batch: int):
        if noise is None:
            return None
        noise = torch.as_tensor(noise)
        if (noise.dtype != torch.float32 or noise.shape != (batch, self.spec.N)
                or noise.device.type != self.device.type
                or not noise.is_contiguous()):
            raise ValueError(f"noise must be contiguous float32 [{batch}, "
                             f"{self.spec.N}] on {self.device}, got "
                             f"{noise.dtype} {tuple(noise.shape)} on "
                             f"{noise.device}")
        return noise

    def _draw(self, seed, sigma, batch: int, noise):
        noise = self._check_noise(noise, batch)
        return mc_draw(self.spec, _check_seed(seed), sigma, batch,
                       self.device, noise)

    def _launch(self, name: str, seed, sigma, batch: int, noise, **out):
        noise = self._check_noise(noise, batch)
        s0, s1 = _check_seed(seed)
        self.decoder.kernels.launch(name, batch, self.device, noise=noise,
                                    seed0=s0, seed1=s1,
                                    sigma=float(np.float32(sigma)), **out)


def build_mc_step(spec: CodeSpec, list_size: int, device="cuda",
                  counters: bool = False) -> McStep:
    """The fused Monte-Carlo step on `device` (the card unless the caller
    asks for the CPU; raises RuntimeError for the card when none is
    present). A step given `noise` [B, N] of standard normals uses them in
    place of its own Box-Muller draw (a test hook)."""
    return McStep(spec, list_size, device, counters=counters)
