"""Alpha compositing (counterpart of `i2sdf_tpu/ops/compositing.py`): the
foreground weights and the NeRF++ background's."""

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


def render_weights_bg(z_vals_bg: torch.Tensor,
                      density: torch.Tensor) -> torch.Tensor:
    """NeRF++ background compositing weights.

    z_vals_bg: (R, S) descending inverse depths (flipped 1 -> 0); density:
    (R, S). The last interval is 1e10 wide. The transmittance's sum is
    exclusive by construction (a zero, then the free energies but the
    last): formed as the inclusive sum minus the sample's own term, every
    digit next to the 1e10 interval would be lost."""
    dists = torch.cat([z_vals_bg[:, :-1] - z_vals_bg[:, 1:],
                       torch.full_like(z_vals_bg[:, :1], 1e10)], dim=-1)
    free_energy = dists * density
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]),
                         free_energy[:, :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    return alpha * torch.exp(-prefix_sum(shifted))
