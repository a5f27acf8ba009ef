"""Inverse-CDF sampling primitives (counterpart of
`i2sdf_tpu/ops/sampling.py`).

The reference's `prefix_sum` is a hi/lo-split bf16 triangular matmul, a
workaround for the TPU's matrix unit; here it is `torch.cumsum` in f32.
"""

from __future__ import annotations

import torch


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis (f32)."""
    return torch.cumsum(x, dim=-1)


def stratify(z_vals: torch.Tensor, t_rand: torch.Tensor) -> torch.Tensor:
    """Jitter each sample within its midpoint-delimited bin; t_rand holds
    U[0, 1) draws of z_vals' shape (`i2sdf_tpu/ops/sampling.py:45`, whose
    key draws them there)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def linear_z_vals(near: torch.Tensor, far: torch.Tensor,
                  n: int) -> torch.Tensor:
    """near/far: (R, 1) -> (R, n) linearly spaced depths."""
    t = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=near.device)
    return near * (1.0 - t) + far * t


def sample_cdf(bins: torch.Tensor, cdf: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Inverse-transform sampling from a per-ray piecewise-linear CDF.

    bins, cdf: (R, B), cdf nondecreasing from 0; u: (R, N) in [0, 1].
    The bracket is `searchsorted(side="right")`, with the reference's
    denom < 1e-5 -> 1 guard."""
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def pdf_to_cdf(pdf: torch.Tensor) -> torch.Tensor:
    """Normalize a per-ray pdf and prepend a zero: (R, B-1) -> (R, B).
    All-zero rows fall back to a uniform pdf instead of 0/0."""
    total = pdf.sum(dim=-1, keepdim=True)
    pdf = torch.where(total > 0, pdf / torch.clamp(total, min=1e-30),
                      torch.full_like(pdf, 1.0 / pdf.shape[-1]))
    cdf = prefix_sum(pdf)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
