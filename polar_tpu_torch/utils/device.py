"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall-back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises RuntimeError for a CUDA device
    when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch version")
    return dev
