"""Alpha compositing (counterpart of `i2sdf_tpu/ops/compositing.py`)."""

from __future__ import annotations

import torch

from .sampling import prefix_sum


def render_weights(z_vals: torch.Tensor, z_max: torch.Tensor,
                   density: torch.Tensor):
    """VolSDF foreground compositing weights.

    z_vals: (R, S) sorted depths; z_max: (R,) the stripped last sample;
    density: (R, S). Returns (weights (R, S), bg_transmittance (R,))."""
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       z_max[:, None] - z_vals[:, -1:]], dim=-1)
    free_energy = dists * density
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]), free_energy],
                        dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-prefix_sum(shifted))
    return alpha * transmittance[:, :-1], transmittance[:, -1]
