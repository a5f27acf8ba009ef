"""Differentiation-safe vector math (counterpart of
`i2sdf_tpu/utils/jmath.py`).

The norm is clamped inside the square root so its gradient at zero is zero
instead of NaN.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-24) -> torch.Tensor:
    """||x|| with zero (not NaN) gradient at x == 0."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=keepdim),
                                  min=eps))


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-12) -> torch.Tensor:
    """x/||x|| with bounded gradient near x == 0."""
    return x / torch.clamp(safe_norm(x, dim=dim, keepdim=True), min=eps)
