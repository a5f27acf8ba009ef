"""SDF -> volume density (counterpart of `i2sdf_tpu/models/density.py`)."""

from __future__ import annotations

import torch


def effective_beta(beta_param: torch.Tensor,
                   beta_min: float = 1e-4) -> torch.Tensor:
    """Learnable raw beta -> strictly positive beta (|b| + beta_min)."""
    return beta_param.abs() + beta_min


def laplace_density(sdf: torch.Tensor, beta) -> torch.Tensor:
    """alpha * Laplace(0, beta).CDF(-sdf) with alpha = 1/beta, written as
    alpha*(0.5 + 0.5*sign(sdf)*expm1(-|sdf|/beta))."""
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf)
                    * torch.expm1(-sdf.abs() / beta))


def abs_density(x: torch.Tensor) -> torch.Tensor:
    """NeRF++ background density: |sigma| (JAX `density.py:27`)."""
    return x.abs()
