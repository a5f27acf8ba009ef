"""Activations (counterpart of `i2sdf_tpu/models/mlp.py::softplus_beta`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Softplus with sharpness beta, linear where beta*x > 20
    (torch `nn.Softplus(beta=100)` semantics)."""
    return torch.where(beta * x > 20.0, x, F.softplus(beta * x) / beta)
