"""SDF and radiance MLPs (counterpart of `i2sdf_tpu/models/mlp.py`).

Weight-normalized linear layers `lin{i}` = {v, g, b} with `v` stored
(in, out), as the JAX package stores them, so the forward is `x @ W + b`
and parameters cross between the packages without a transpose
(`i2sdf_tpu_torch/params.py`). Geometric sphere init, skip connections
scaled by 1/sqrt(2), Softplus(100), bounding-sphere clamp.

Compute is f32 everywhere in these modules; the CUDA kernels
(`ops/kernels/`) take bf16 operands with f32 accumulation and are held to
these functions within a stated tolerance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from ..ops.activations import softplus_beta
from .embedder import pe_dim, positional_encoding


def _check_embed(embed_type):
    if embed_type not in (None, "positional"):
        raise ValueError(f"embed_type {embed_type!r} is not ported yet "
                         "(only 'positional')")


@dataclasses.dataclass(frozen=True)
class ImplicitNetConfig:
    feature_vector_size: int
    sdf_bounding_sphere: float
    d_in: int = 3
    d_out: int = 1
    dims: Sequence[int] = (256,) * 8
    geometric_init: bool = True
    bias: float = 1.0
    skip_in: Sequence[int] = ()
    weight_norm: bool = True
    embed_type: str | None = None
    multires: int = 6
    sphere_scale: float = 1.0

    def __post_init__(self):
        _check_embed(self.embed_type)

    def layer_dims(self) -> list[int]:
        dims = ([self.d_in] + list(self.dims)
                + [self.d_out + self.feature_vector_size])
        if self.embed_type:
            dims[0] = pe_dim(self.multires, self.d_in)
        return dims

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return positional_encoding(x, self.multires) if self.embed_type else x


@dataclasses.dataclass(frozen=True)
class RenderingNetConfig:
    feature_vector_size: int
    mode: str = "nerf"
    d_in: int = 3
    d_out: int = 3
    dims: Sequence[int] = (256,) * 4
    weight_norm: bool = True
    embed_type: str | None = None
    multires: int = 4
    output_activation: str = "sigmoid"

    def __post_init__(self):
        _check_embed(self.embed_type)
        if self.mode != "nerf" or self.output_activation != "sigmoid":
            raise ValueError("only the nerf-mode, sigmoid-output radiance "
                             "net is ported yet")

    def layer_dims(self) -> list[int]:
        d0 = self.d_in + self.feature_vector_size
        if self.embed_type:
            d0 += pe_dim(self.multires) - 3
        return [d0] + list(self.dims) + [self.d_out]

    def embed(self, d: torch.Tensor) -> torch.Tensor:
        return positional_encoding(d, self.multires) if self.embed_type else d


class WNLinear(nn.Module):
    """Linear layer with torch `weight_norm` semantics, weights (in, out)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, weight_norm: bool):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(w.clone())
            self.g = nn.Parameter(torch.linalg.norm(w, dim=0))
        else:
            self.w = nn.Parameter(w.clone())
        self.b = nn.Parameter(b.clone())

    def weight(self) -> torch.Tensor:
        """Effective (in, out) weight."""
        if self.weight_norm:
            norm = torch.linalg.norm(self.v, dim=0, keepdim=True)
            return self.v * (self.g[None, :] / torch.clamp(norm, min=1e-12))
        return self.w


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


class ImplicitNet(nn.Module):
    """SDF + feature MLP: (N, d_in) -> (N, d_out + feature_vector_size)."""

    def __init__(self, cfg: ImplicitNetConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dims = cfg.layer_dims()
        n = len(dims) - 1
        for layer in range(n):
            in_dim = dims[layer]
            out_dim = (dims[layer + 1] - dims[0] if layer + 1 in cfg.skip_in
                       else dims[layer + 1])
            if not cfg.geometric_init:
                w = _uniform(generator, (in_dim, out_dim),
                             1.0 / math.sqrt(in_dim))
                b = _uniform(generator, (out_dim,), 1.0 / math.sqrt(in_dim))
            elif layer == n - 1:
                w = (_normal(generator, (in_dim, out_dim), 1e-4)
                     + math.sqrt(math.pi) / math.sqrt(in_dim))
                b = torch.full((out_dim,), -cfg.bias)
            else:
                std = math.sqrt(2) / math.sqrt(out_dim)
                if cfg.embed_type and layer == 0:
                    w = torch.zeros((in_dim, out_dim))
                    w[:3] = _normal(generator, (3, out_dim), std)
                else:
                    w = _normal(generator, (in_dim, out_dim), std)
                    if cfg.embed_type and layer in cfg.skip_in:
                        w[-(dims[0] - 3):] = 0.0
                b = torch.zeros((out_dim,))
            setattr(self, f"lin{layer}", WNLinear(w, b, cfg.weight_norm))
        self.n_layers = n

    def layers(self) -> list[WNLinear]:
        return [getattr(self, f"lin{i}") for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lins = self.layers()
        return implicit_apply(self.cfg, [l.weight() for l in lins],
                              [l.b for l in lins], x)


def implicit_apply(cfg: ImplicitNetConfig, ws, bs,
                   x: torch.Tensor) -> torch.Tensor:
    """The implicit net with explicit (in, out) weights and biases:
    (N, d_in) -> (N, d_out + F), unclamped."""
    inp = cfg.embed(x)
    h = inp
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for layer in range(len(ws)):
        if layer in cfg.skip_in:
            h = torch.cat([h, inp], dim=-1) * inv_sqrt2
        h = h @ ws[layer] + bs[layer]
        if layer < len(ws) - 1:
            h = softplus_beta(h, 100.0)
    return h


def clamp_sdf(cfg: ImplicitNetConfig, sdf: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Bounding-sphere clamp min(sdf, scale * (R - |x|))."""
    if cfg.sdf_bounding_sphere > 0.0:
        sphere = cfg.sphere_scale * (cfg.sdf_bounding_sphere
                                     - torch.linalg.norm(x, dim=-1,
                                                         keepdim=True))
        sdf = torch.minimum(sdf, sphere)
    return sdf


def sdf_vals(net: ImplicitNet, x: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 1) clamped SDF, no gradient."""
    with torch.no_grad():
        return clamp_sdf(net.cfg, net(x)[:, :1], x)


def sdf_outputs(net: ImplicitNet, x: torch.Tensor):
    """(sdf (N, 1), features (N, F), spatial gradient (N, 3)) of the
    clamped SDF, the gradient by `torch.autograd.grad`. Nothing here is
    kept for a backward pass through the parameters (eval only)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = net(xg)
        sdf = clamp_sdf(net.cfg, out[:, :1], xg)
        (grad,) = torch.autograd.grad(sdf.sum(), xg)
    return sdf.detach(), out[:, 1:].detach(), grad


class RenderingNet(nn.Module):
    """nerf-mode radiance: [PE(view), feature] -> ReLU MLP -> sigmoid."""

    def __init__(self, cfg: RenderingNetConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dims = cfg.layer_dims()
        self.n_layers = len(dims) - 1
        for layer in range(self.n_layers):
            bound = 1.0 / math.sqrt(dims[layer])
            w = _uniform(generator, (dims[layer], dims[layer + 1]), bound)
            b = _uniform(generator, (dims[layer + 1],), bound)
            setattr(self, f"lin{layer}", WNLinear(w, b, cfg.weight_norm))

    def layers(self) -> list[WNLinear]:
        return [getattr(self, f"lin{i}") for i in range(self.n_layers)]

    def forward(self, view_dirs: torch.Tensor,
                features: torch.Tensor) -> torch.Tensor:
        lins = self.layers()
        return rendering_apply(self.cfg, [l.weight() for l in lins],
                               [l.b for l in lins], view_dirs, features)


def rendering_apply(cfg: RenderingNetConfig, ws, bs, view_dirs: torch.Tensor,
                    features: torch.Tensor) -> torch.Tensor:
    """The radiance net with explicit (in, out) weights and biases."""
    h = torch.cat([cfg.embed(view_dirs), features], dim=-1)
    for layer in range(len(ws)):
        h = h @ ws[layer] + bs[layer]
        if layer < len(ws) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)
