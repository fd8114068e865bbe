"""BPSK modulation, AWGN channel, LLR demodulation (PyTorch).

Counterpart of polar_tpu/sim/channel.py. Conventions: bit 0 -> +1,
bit 1 -> -1; noise variance sigma^2 = 1 / (2 * R * 10^(EbN0/10));
llr = 2y / sigma^2 (positive llr favors bit 0). Noise comes from an
explicit torch.Generator, or is injected (tests feed both packages the
same standard-normal draws).
"""
from __future__ import annotations

import numpy as np
import torch


def ebn0_to_sigma(ebn0_db, rate: float, device=None) -> torch.Tensor:
    """Noise standard deviation (float32 scalar tensor) for BPSK at the
    given Eb/N0 (dB) and code rate. Computed on the host in float32 with
    IEEE-rounded numpy operations, which give the JAX package's sigma bit
    for bit (PyTorch's CPU sqrt of a 0-d tensor can differ by one ulp)."""
    ebn0 = np.float32(10.0) ** (np.float32(ebn0_db) / np.float32(10.0))
    sigma = np.sqrt(np.float32(1.0) / (np.float32(2.0 * rate) * ebn0))
    return torch.tensor(sigma, dtype=torch.float32, device=device)


def modulate(bits: torch.Tensor) -> torch.Tensor:
    """0 -> +1.0, 1 -> -1.0."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def awgn(symbols: torch.Tensor, sigma, generator: torch.Generator | None = None,
         noise: torch.Tensor | None = None) -> torch.Tensor:
    """symbols + sigma * n, n standard normal: drawn from `generator`, or
    the given `noise` tensor (exactly one of the two)."""
    if (generator is None) == (noise is None):
        raise ValueError("pass exactly one of generator or noise")
    if noise is None:
        noise = torch.randn(symbols.shape, generator=generator,
                            dtype=torch.float32, device=symbols.device)
    return symbols + sigma * noise.to(torch.float32)


def llr_demod(y: torch.Tensor, sigma) -> torch.Tensor:
    return 2.0 * y / (sigma * sigma)


def channel_llrs(codeword_bits: torch.Tensor, ebn0_db, rate: float,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """bits -> noisy channel LLRs in one shot."""
    sigma = ebn0_to_sigma(ebn0_db, rate, device=codeword_bits.device)
    y = awgn(modulate(codeword_bits), sigma, generator=generator, noise=noise)
    return llr_demod(y, sigma)
