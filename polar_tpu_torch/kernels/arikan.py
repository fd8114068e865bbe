"""Arikan 2x2 kernel and its min-sum LLR update functions (PyTorch).

Counterpart of polar_tpu/kernels/arikan.py. Conventions:
  f(a, b) = sign(a)sign(b) * min(|a|, |b|)     (min-sum check update)
  g(a, b, u0) = b + (1 - 2*u0) * a             (variable update)
  sign(0) treated as +1: torch.sign(0) is 0, so the sign comes from where.
"""
from __future__ import annotations

import numpy as np
import torch

F2 = np.array([[1, 0], [1, 1]], dtype=np.uint8)


def f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check-node (i=0) LLR update, min-sum approximation."""
    sign = torch.where((a < 0) ^ (b < 0), -1.0, 1.0).to(a.dtype)
    return sign * torch.minimum(a.abs(), b.abs())


def g_update(a: torch.Tensor, b: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """Variable-node (i=1) LLR update given the decision u0 for input 0."""
    return b + (1.0 - 2.0 * u0.to(a.dtype)) * a


def f_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check-node (i=0) LLR update, exact boxplus
    2*atanh(tanh(a/2)*tanh(b/2)), in the numerically stable log-domain
    form  f_minsum(a, b) + log1p(e^{-(|a|+|b|)}) - log1p(e^{-||a|-|b||})."""
    aa, ab = a.abs(), b.abs()
    corr = (torch.log1p(torch.exp(-(aa + ab)))
            - torch.log1p(torch.exp(-(aa - ab).abs())))
    sign = torch.where((a < 0) ^ (b < 0), -1.0, 1.0).to(a.dtype)
    return f_minsum(a, b) + sign * corr.to(a.dtype)
