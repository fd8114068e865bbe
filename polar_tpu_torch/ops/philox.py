"""Philox4x32-10 counter-based random numbers, plain PyTorch.

Counterpart of the TPU PRNG calls in the fused Monte-Carlo kernel
(polar_tpu/ops/pallas_scl.py, `pltpu.prng_seed` / `prng_random_bits`).
The TPU's hardware bits cannot be reproduced elsewhere, so the port pins
its own stream, shared word for word by the CUDA kernel
(csrc/scl_decode.cu `philox4x32_10`), this plain version and the tests:

    word w of codeword b in one call = output (w mod 4) of Philox4x32-10
    with key (seed0, seed1) and counter (w div 4, b, 0, 0).

PyTorch has no general uint32 arithmetic, and an int64 product of two
32-bit words overflows, so the 32 x 32 -> 64 bit products split one
factor into 16-bit halves; every word lives in an int64 tensor, masked
to 32 bits.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # key increments (Weyl)
ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a < 2^32 and b an
    int64 tensor of 32-bit words, without leaving int64's range."""
    low = a * (b & 0xFFFF)                   # < 2^48
    mid = a * (b >> 16)                      # < 2^48
    t = low + ((mid & 0xFFFF) << 16)         # < 2^49
    return (mid >> 16) + (t >> 32), t & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words c0..c3 (int64 tensors of 32-bit
    values, broadcastable) under the key (k0, k1): four int64 tensors."""
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox4x32_10_int(ctr, key) -> tuple[int, int, int, int]:
    """The same function on Python ints (host seeds and test reference)."""
    c0, c1, c2, c3 = (int(v) & MASK32 for v in ctr)
    k0, k1 = (int(v) & MASK32 for v in key)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & MASK32)
    return c0, c1, c2, c3


def random_words(seed: tuple[int, int], batch: int, n_words: int,
                 device=None) -> torch.Tensor:
    """[batch, n_words] int64 tensor of 32-bit words: word w of row b is
    output (w mod 4) of counter (w div 4, b, 0, 0) under key `seed`."""
    if n_words % 4:
        raise ValueError(f"n_words {n_words} is not a multiple of 4")
    c0 = torch.arange(n_words // 4, dtype=torch.int64, device=device)[None, :]
    c1 = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    out = philox4x32_10(c0, c1, zero, zero, int(seed[0]), int(seed[1]))
    out = [o.expand(batch, n_words // 4) for o in out]
    return torch.stack(out, dim=2).reshape(batch, n_words)


def step_seed(seed: int, snr_index: int, step: int, sub: int,
              rank: int = 0) -> tuple[int, int]:
    """Key (seed0, seed1) of one Monte-Carlo batch: the first two words of
    Philox4x32-10 with counter (step, sub, snr_index, rank) and key
    (seed mod 2^32, seed >> 32). A function of the position in the sweep
    and of the rank of a multi-device sweep alone, so a resumed sweep
    draws the same frames; rank 0 draws the frames of a single-device
    sweep."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed {seed} must be non-negative")
    if not 0 <= rank <= MASK32:
        raise ValueError(f"rank {rank} is not a 32-bit counter word")
    w = philox4x32_10_int((step, sub, snr_index, rank),
                          (seed & MASK32, (seed >> 32) & MASK32))
    return w[0], w[1]
