"""Genie-aided Monte-Carlo frozen-set construction (any kernel mix), PyTorch.

Counterpart of polar_tpu/construction/montecarlo.py. Transmit the
all-zero codeword through BPSK-AWGN at the design SNR, run SC with every
decision forced correct (the genie decoder, `build_scl_decoder(genie=True)`
at list size 1) and count per-leaf LLR sign errors. The error rate of leaf
i estimates the i-th subchannel's unreliability; freeze the worst
N - n_unfrozen leaves.

The decode runs on `device` (the card unless the caller asks for the CPU)
as the op program, with the CUDA stage kernel for every l > 2 trellis /
tail-table DOWN op on a card. The per-leaf counts stay on the device in
int64 and are fetched once, at the end.

The noise is the port's own stream, not `torch.randn`: batch k's
codeword b draws N words of Philox4x32-10 under the key (seed, k)
(ops/philox.py) and turns them into standard normals by the fused
Monte-Carlo step's Box-Muller transform (ops/mc.py `box_muller`), so the
CPU and the card draw the same frames up to libm's last ulp. The JAX
package's `jax.random` stream is another one: the two constructions agree
on the ranking, not frame for frame.
"""
from __future__ import annotations

import numpy as np
import torch

from polar_tpu_torch.models.polar import CodeSpec
from polar_tpu_torch.ops.mc import _check_seed, box_muller, mc_channel
from polar_tpu_torch.ops.philox import random_words
from polar_tpu_torch.ops.scl import build_scl_decoder
from polar_tpu_torch.sim.channel import ebn0_to_sigma
from polar_tpu_torch.utils.device import resolve_device


def genie_decoder(factors: tuple[int, ...], device):
    """decode(llrs [B, N]) -> DecodeResult whose u [B, N] marks each leaf's
    error: the genie decoder of the kernel mix `factors` on `device`, the
    l > 2 DOWN ops in the stage kernel on a card (its plain version on the
    CPU: the same floats)."""
    N = int(np.prod(factors))
    # the frozen mask is irrelevant in genie mode; use all-frozen
    spec = CodeSpec(N=N, K=0, factors=tuple(factors), frozen_mask=(1,) * N,
                    crc=None)
    return build_scl_decoder(spec, 1, device=device, genie=True,
                             big_stage_backend="pallas")


def genie_llrs(N: int, sigma: float, seed: int, k: int, batch: int,
               device) -> torch.Tensor:
    """[batch, N] float32 channel LLRs of the all-zero codeword for batch
    k: Box-Muller normals from Philox key (seed, k), the fused step's
    channel (ops/mc.py `mc_channel`)."""
    gauss = box_muller(random_words(_check_seed((seed, k)), batch, N, device))
    return mc_channel(torch.zeros_like(gauss, dtype=torch.int8), gauss, sigma)


def leaf_error_counts(decode, llrs: torch.Tensor) -> torch.Tensor:
    """[N] int64 per-leaf error counts of one batch of LLRs on the genie
    decoder `decode`."""
    return decode(llrs).u.sum(dim=0, dtype=torch.int64)


def mc_leaf_error_rates(factors: tuple[int, ...], design_ebn0_db: float,
                        rate: float, frames: int = 1 << 14,
                        batch: int = 1 << 10, seed: int = 0,
                        device="cuda") -> np.ndarray:
    """Per-leaf genie error rates [N] at the design SNR, over whole batches
    (at least `frames` frames)."""
    dev = resolve_device(device)
    N = int(np.prod(factors))
    decode = genie_decoder(tuple(factors), dev)
    sigma = float(ebn0_to_sigma(design_ebn0_db, rate))
    counts = torch.zeros(N, dtype=torch.int64, device=dev)
    done = k = 0
    while done < frames:
        counts += leaf_error_counts(decode, genie_llrs(N, sigma, seed, k,
                                                       batch, dev))
        done += batch
        k += 1
    return counts.cpu().numpy() / done


def frozen_from_rates(err: np.ndarray, n_unfrozen: int) -> np.ndarray:
    """Frozen mask (1 = frozen): the n_unfrozen leaves of the lowest error
    rate unfrozen, ties to the lower index."""
    order = np.argsort(err, kind="stable")      # most reliable first
    frozen = np.ones(err.size, dtype=np.uint8)
    frozen[order[:n_unfrozen]] = 0
    return frozen


def construct_mc(factors: tuple[int, ...], n_unfrozen: int,
                 design_ebn0_db: float, rate: float | None = None,
                 frames: int = 1 << 14, seed: int = 0,
                 device="cuda") -> np.ndarray:
    """Frozen mask (1 = frozen) by genie Monte-Carlo at the design SNR."""
    N = int(np.prod(factors))
    r = rate if rate is not None else n_unfrozen / N
    err = mc_leaf_error_rates(tuple(factors), design_ebn0_db, r,
                              frames=frames, seed=seed, device=device)
    return frozen_from_rates(err, n_unfrozen)
