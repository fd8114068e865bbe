"""The BPSK-AWGN channel's noise level: a frozen copy of
polar_tpu_torch/sim/channel.py `ebn0_to_sigma`."""
from __future__ import annotations

import numpy as np


def ebn0_to_sigma(ebn0_db, rate: float) -> float:
    """Noise standard deviation for BPSK at Eb/N0 (dB) and code rate:
    sigma^2 = 1 / (2 R 10^(EbN0/10)), computed in float32 with IEEE-rounded
    numpy operations."""
    ebn0 = np.float32(10.0) ** (np.float32(ebn0_db) / np.float32(10.0))
    return float(np.sqrt(np.float32(1.0) / (np.float32(2.0 * rate) * ebn0)))
