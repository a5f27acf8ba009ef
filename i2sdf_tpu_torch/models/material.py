"""Spatial material field and learnable emission (counterpart of
`i2sdf_tpu/models/material.py`), the trainable core of the material
stage (`train/material.py`).

`MaterialNet` maps a world-space surface point (positional encoding of
`multires` frequencies) through a ReLU MLP of weight-normalized layers
`lin{i}` = {v, g, b} (weights (in, out), as `models/mlp.py` stores them,
so parameters cross with `params.py` as they are) to a 7-wide head:
sigmoid kd (3), sigmoid ks (3) and a roughness floored at `min_roughness`
(`min + (1 - min) * sigmoid`). The emission is a plain dict of tensors
in log space: `log_radiance` (E, 3), one row an emitter, and
`log_ambient` (3,), a global ambient irradiance; `MaterialStage` holds
both as the trainer's module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from .embedder import pe_dim, positional_encoding
from .mlp import WNLinear, _uniform


@dataclasses.dataclass(frozen=True)
class MaterialNetConfig:
    d_in: int = 3
    dims: Sequence[int] = (256,) * 4
    weight_norm: bool = True
    embed_type: str | None = "positional"
    multires: int = 6
    min_roughness: float = 0.04

    def __post_init__(self):
        if self.embed_type not in (None, "positional"):
            raise ValueError(f"material net embed_type {self.embed_type!r} "
                             "is not ported (only 'positional')")

    def layer_dims(self) -> list[int]:
        d0 = pe_dim(self.multires, self.d_in) if self.embed_type else self.d_in
        # head: kd (3) + ks (3) + roughness (1)
        return [d0] + list(self.dims) + [7]

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return positional_encoding(x, self.multires) if self.embed_type else x

    @classmethod
    def from_cfgnode(cls, node) -> "MaterialNetConfig":
        return cls(
            d_in=node.get("d_in", 3),
            dims=tuple(node.get("dims", (256,) * 4)),
            weight_norm=node.get("weight_norm", True),
            embed_type=node.get("embed_type", "positional"),
            multires=node.get("multires", 6),
            min_roughness=node.get("min_roughness", 0.04),
        )


class MaterialNet(nn.Module):
    """(N, 3) points -> {'kd': (N, 3), 'ks': (N, 3), 'rough': (N,)}."""

    def __init__(self, cfg: MaterialNetConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dims = cfg.layer_dims()
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            bound = 1.0 / math.sqrt(dims[i])
            w = _uniform(generator, (dims[i], dims[i + 1]), bound)
            b = _uniform(generator, (dims[i + 1],), bound)
            setattr(self, f"lin{i}", WNLinear(w, b, cfg.weight_norm))

    def forward(self, x: torch.Tensor) -> dict:
        h = self.cfg.embed(x)
        for i in range(self.n_layers):
            lin = getattr(self, f"lin{i}")
            h = h @ lin.weight() + lin.b
            if i < self.n_layers - 1:
                h = torch.relu(h)
        m = self.cfg.min_roughness
        return {"kd": torch.sigmoid(h[:, 0:3]),
                "ks": torch.sigmoid(h[:, 3:6]),
                "rough": m + (1.0 - m) * torch.sigmoid(h[:, 6])}


def emission_init(radiance, ambient: float = 0.02) -> dict:
    """Log-space emission parameters: `log_radiance` = log(max(radiance,
    1e-4)) (E, 3), `log_ambient` = log of `ambient` in each channel
    (3,)."""
    radiance = torch.as_tensor(radiance, dtype=torch.float32)
    return {"log_radiance": torch.log(torch.clamp(radiance, min=1e-4)),
            "log_ambient": torch.log(torch.full((3,), float(ambient)))}


class MaterialStage(nn.Module):
    """What the material stage trains: `material` (a `MaterialNet`) and
    `emission` (`log_radiance`, `log_ambient`), under the JAX tree's names
    (`{"material": ..., "emission": ...}`; `params.py` converts)."""

    def __init__(self, cfg: MaterialNetConfig, radiance, seed: int = 0,
                 ambient: float = 0.02):
        super().__init__()
        self.cfg = cfg
        self.material = MaterialNet(cfg,
                                    torch.Generator().manual_seed(seed))
        self.emission = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in emission_init(
                radiance, ambient).items()})


def emission_apply(params: dict) -> torch.Tensor:
    """(E, 3) per-emitter radiance."""
    return torch.exp(params["log_radiance"])


def ambient_apply(params: dict) -> torch.Tensor:
    """(3,) global ambient irradiance (zeros without `log_ambient`)."""
    if "log_ambient" not in params:
        return torch.zeros(3, device=params["log_radiance"].device)
    return torch.exp(params["log_ambient"])
