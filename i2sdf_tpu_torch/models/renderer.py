"""I2SDF volume renderer (counterpart of `i2sdf_tpu/models/renderer.py`).

`I2SDFModel` holds the SDF net, the radiance net and the learnable beta.
`render_rays` renders a batch of rays at eval (`training=False` in the
reference): foreground only, with rgb, depth and the normal map, through
K1-K3. `render_rays_train` is the training render (`renderer.py:299-311,
345-394,470-499`); it returns what the losses read (`grad_theta`,
`diff_norm`, `surface_sdf` on the bubble points, `normal_values` under
`use_normal`), differentiable with respect to the model's parameters,
and takes one of two routes, chosen as the JAX renderer chooses
(`returns_grad`, `renderer.py:294`):

* normal losses on (`use_normal`): the render core, K3 forward and K4
  backward, on the render points and the eikonal points folded into one
  batch with zero directions (`renderer.py:345-377`);
* normal losses off: the render points through the SDF net with no
  spatial gradient and then the radiance net, in plain PyTorch (large
  matrix products that the JAX package leaves to XLA,
  `renderer.py:387-394`), and `grad_theta` of the eikonal points through
  K5 forward and K6 backward (`get_rev_op`, `renderer.py:473-477`).

The sampler runs K1 and K2 on both routes. Its random numbers come in a
`RenderDraws` bundle. Still refused, with a message: the light head
(`model.light_network`), the NeRF++ background (`model.bg_network`), the
per-ray sampler exit (`ray_sampler.per_ray_exit`, `early_exit: false`),
idr-mode radiance and the SH/Fourier encodings.

Compute is f32 in the plain path on either device; on the card the hot
functions run as CUDA kernels with bf16 operands and f32 accumulation
(`ops/kernels/`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops.compositing import render_weights
from ..ops.kernels import render_core, rev, sampler_round, sdf_mlp
from ..utils.cameras import get_camera_params
from ..utils.jmath import safe_norm, safe_normalize
from .density import effective_beta, laplace_density
from .mlp import (ImplicitNet, ImplicitNetConfig, RenderingNet,
                  RenderingNetConfig, clamp_sdf)
from .sampler import SamplerConfig, SamplerDraws, error_bound_z_vals


@dataclasses.dataclass(frozen=True)
class I2SDFConfig:
    feature_vector_size: int = 256
    scene_bounding_sphere: float = 3.0
    implicit: ImplicitNetConfig = None
    rendering: RenderingNetConfig = None
    sampler: SamplerConfig = None
    beta_init: float = 0.1
    beta_min: float = 1e-4
    use_normal: bool = False

    @classmethod
    def from_cfgnode(cls, conf: Any) -> "I2SDFConfig":
        """Build from a `model:` config section. Everything is computed in
        f32 (the reference's `compute_dtype` key is not read: its TPU
        default was bf16 matmul operands, which the port's kernels take
        on their own)."""
        for key in ("light_network", "bg_network"):
            if key in conf:
                raise ValueError(f"model.{key} is not ported yet")
        rs = conf.ray_sampler
        if rs.get("per_ray_exit", False) or not rs.get("early_exit", True):
            raise ValueError("only the global early-exit sampler is ported")
        fvs = conf.feature_vector_size
        sphere = conf.get("scene_bounding_sphere", 1.0)
        imp = conf.implicit_network
        implicit = ImplicitNetConfig(
            feature_vector_size=fvs,
            sdf_bounding_sphere=0.0,  # the reference model passes 0.0
            d_in=imp.get("d_in", 3),
            d_out=imp.get("d_out", 1),
            dims=tuple(imp.dims),
            geometric_init=imp.get("geometric_init", True),
            bias=imp.get("bias", 1.0),
            skip_in=tuple(imp.get("skip_in", []) or []),
            weight_norm=imp.get("weight_norm", True),
            embed_type=imp.get("embed_type", None),
            multires=imp.get("multires", 6),
            sphere_scale=imp.get("sphere_scale", 1.0),
        )
        ren = conf.rendering_network
        rendering = RenderingNetConfig(
            feature_vector_size=fvs,
            mode=ren.get("mode", "nerf"),
            d_in=ren.get("d_in", 3),
            d_out=ren.get("d_out", 3),
            dims=tuple(ren.dims),
            weight_norm=ren.get("weight_norm", True),
            embed_type=ren.get("embed_type", None),
            multires=ren.get("multires", 4),
        )
        sampler = SamplerConfig(
            scene_bounding_sphere=sphere,
            near=rs.get("near", 0.0),
            N_samples=rs.N_samples,
            N_samples_eval=rs.N_samples_eval,
            N_samples_extra=rs.N_samples_extra,
            eps=rs.get("eps", 0.1),
            beta_iters=rs.get("beta_iters", 10),
            max_total_iters=rs.get("max_total_iters", 5),
            add_tiny=rs.get("add_tiny", 0.0),
            round_eval_counts=(tuple(rs["round_eval_counts"])
                               if "round_eval_counts" in rs else None),
        )
        return cls(feature_vector_size=fvs, scene_bounding_sphere=sphere,
                   implicit=implicit, rendering=rendering, sampler=sampler,
                   beta_init=conf.density.params_init.beta,
                   beta_min=conf.density.get("beta_min", 1e-4),
                   use_normal=conf.get("use_normal", False))


class I2SDFModel(nn.Module):
    """Parameters of the model: `implicit`, `rendering` and raw `beta`."""

    def __init__(self, cfg: I2SDFConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.implicit = ImplicitNet(cfg.implicit, gen)
        self.rendering = RenderingNet(cfg.rendering, gen)
        self.beta = nn.Parameter(torch.tensor(cfg.beta_init,
                                              dtype=torch.float32))


@dataclasses.dataclass
class KernelWeights:
    """The model's weights in the kernels' layouts, packed once per render
    (weight norm materialized, bf16, mma fragment order)."""
    sdf: sdf_mlp.SdfMlpPack
    core: render_core.RenderCorePack

    @classmethod
    def pack(cls, model: I2SDFModel) -> "KernelWeights":
        return cls(sdf=sdf_mlp.SdfMlpPack(model.implicit),
                   core=render_core.RenderCorePack(model.implicit,
                                                   model.rendering))


def _camera_rays(inputs: dict):
    """Unit ray directions, camera centres and the directions' norms,
    one row per ray."""
    ray_dirs_b, cam_loc_b = get_camera_params(
        inputs["uv"], inputs["pose"], inputs["intrinsics"])
    B, N = ray_dirs_b.shape[:2]
    cam_loc = cam_loc_b[:, None, :].expand(B, N, 3).reshape(-1, 3)
    ray_dirs = ray_dirs_b.reshape(-1, 3)
    norm = torch.linalg.norm(ray_dirs, dim=-1)
    return ray_dirs / torch.clamp(norm[:, None], min=1e-12), cam_loc, norm


def _sampler_fns(model: I2SDFModel, sdf_pack, plain: bool):
    cfg = model.cfg
    if plain:
        def sdf_fn(pts):
            return sdf_mlp.sdf_mlp_plain(model.implicit, pts)

        def round_impl(*a):
            return sampler_round.sampler_round_plain(cfg.sampler, *a)
    else:
        def sdf_fn(pts):
            return sdf_mlp.sdf_mlp_nograd(sdf_pack, pts)

        def round_impl(*a):
            return sampler_round.sampler_round(cfg.sampler, *a)
    return sdf_fn, round_impl


@dataclasses.dataclass
class RenderDraws:
    """The random numbers of one training render of R rays
    (`renderer.py:246,305-314`): the sampler's, the eikonal points drawn
    uniformly in the scene's bounding cube, and the jitter of their
    near-surface neighbours."""
    sampler: SamplerDraws
    eik_uniform: torch.Tensor   # (R, 3) in [-sphere, sphere)
    jitter: torch.Tensor        # (R, 3) in [-0.005, 0.005)

    @classmethod
    def sample(cls, cfg: I2SDFConfig, n_rays: int,
               gen: torch.Generator) -> "RenderDraws":
        dev, s = gen.device, cfg.scene_bounding_sphere
        return cls(
            sampler=SamplerDraws.sample(cfg.sampler, n_rays, gen),
            eik_uniform=(torch.rand((n_rays, 3), generator=gen, device=dev)
                         * (2 * s) - s),
            jitter=(torch.rand((n_rays, 3), generator=gen, device=dev)
                    * 0.01 - 0.005))


def render_rays_train(model: I2SDFModel, inputs: dict, draws: RenderDraws,
                      plain: bool = False) -> dict:
    """Render a batch of rays for a training step.

    inputs as `render_rays`'s, plus an optional "pointcloud" (P, 3) of
    bubble points. The sampler and the kernels of the route (module
    docstring) go through their wrappers: CUDA kernels on CUDA tensors,
    the plain versions on CPU tensors, or the plain versions anywhere
    with `plain=True`. The sampler sees the current weights (packed here)
    and beta, without gradient."""
    cfg = model.cfg
    with torch.no_grad():
        ray_dirs, cam_loc, ray_dirs_norm = _camera_rays(inputs)
        R = ray_dirs.shape[0]
        beta0 = effective_beta(model.beta.detach(), cfg.beta_min)
        sdf_pack = None if plain else sdf_mlp.SdfMlpPack(model.implicit)
        sdf_fn, round_impl = _sampler_fns(model, sdf_pack, plain)
        z_all = error_bound_z_vals(cfg.sampler, sdf_fn, ray_dirs, cam_loc,
                                   beta0, round_impl=round_impl,
                                   draws=draws.sampler)
        z_eik = torch.gather(z_all, 1, draws.sampler.eik_idx)
        z_max, z_vals = z_all[:, -1], z_all[:, :-1]
        S = z_vals.shape[1]
        points = (cam_loc[:, None, :]
                  + z_vals[..., None] * ray_dirs[:, None, :]).reshape(-1, 3)
        dirs = ray_dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
        eik_near = cam_loc + z_eik * ray_dirs
        eik_all = torch.cat([draws.eik_uniform, eik_near,
                             eik_near + draws.jitter])

    returns_grad = cfg.use_normal or cfg.rendering.mode == "idr"
    if returns_grad:
        with torch.no_grad():
            pts_in = torch.cat([points, eik_all]).contiguous()
            dirs_in = torch.cat([dirs, torch.zeros_like(eik_all)]).contiguous()
        w = render_core.CoreWeights.of(model.implicit, model.rendering)
        sdf_a, grad_a, rgb_a = render_core.render_core_train(
            cfg.implicit, cfg.rendering, w, pts_in, dirs_in, plain=plain)
        n_main = R * S
        sdf, grad, rgb = sdf_a[:n_main], grad_a[:n_main], rgb_a[:n_main]
        grad_theta = grad_a[n_main:]
    else:
        out_main = model.implicit(points)
        sdf = clamp_sdf(cfg.implicit, out_main[:, :1], points)
        rgb = model.rendering(dirs, out_main[:, 1:])
        _, _, grad_theta = rev.sdf_outputs_rev(model.implicit,
                                               eik_all.contiguous(),
                                               plain=plain)
    beta = effective_beta(model.beta, cfg.beta_min)
    density = laplace_density(sdf, beta).reshape(R, S)
    weights, _ = render_weights(z_vals, z_max, density)
    out = {
        "rgb_values": (weights[..., None] * rgb.reshape(R, S, 3)).sum(1),
        "depth_values": ((weights * z_vals).sum(1)
                         / torch.clamp(ray_dirs_norm, min=1e-6)),
        "weight_sum": weights.sum(-1, keepdim=True),
    }
    out["grad_theta"] = grad_theta[:2 * R]
    pair = safe_normalize(grad_theta[R:])
    out["diff_norm"] = safe_norm(pair[:R] - pair[R:], dim=-1)
    if "pointcloud" in inputs:
        pc = inputs["pointcloud"]
        out["surface_sdf"] = clamp_sdf(cfg.implicit,
                                       model.implicit(pc)[:, :1], pc)
    if cfg.use_normal:
        normals = safe_normalize(grad).reshape(R, S, 3)
        out["normal_values"] = safe_normalize(
            (weights.detach()[..., None] * normals).sum(1))
    return out


def render_rays(model: I2SDFModel, inputs: dict,
                weights: KernelWeights | None = None,
                plain: bool = False) -> dict:
    """Render a batch of rays at eval.

    inputs: {"uv": (B, N, 2), "intrinsics": (B, 4, 4), "pose": (B, 4, 4)}.
    The three hot functions go through their kernel wrappers, which run
    the CUDA kernel on a CUDA tensor and the plain PyTorch version on a
    CPU tensor; `plain=True` takes the plain versions on any device
    (used to hold the kernels' render against the plain one on the card).
    `weights` are the packed kernel weights (packed here if None)."""
    cfg = model.cfg
    if weights is None and not plain:
        weights = KernelWeights.pack(model)
    with torch.no_grad():
        ray_dirs, cam_loc, ray_dirs_norm = _camera_rays(inputs)
        R = ray_dirs.shape[0]
        beta = effective_beta(model.beta, cfg.beta_min)
        sdf_fn, round_impl = _sampler_fns(
            model, None if plain else weights.sdf, plain)
        z_all = error_bound_z_vals(cfg.sampler, sdf_fn, ray_dirs, cam_loc,
                                   beta, round_impl=round_impl)
        z_max = z_all[:, -1]
        z_vals = z_all[:, :-1]
        S = z_vals.shape[1]
        points = (cam_loc[:, None, :]
                  + z_vals[..., None] * ray_dirs[:, None, :]).reshape(-1, 3)
        dirs = ray_dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)

        if plain:
            sdf, grad, rgb = render_core.render_core_plain(
                model.implicit, model.rendering, points, dirs)
        else:
            sdf, grad, rgb = render_core.render_core_fwd(weights.core,
                                                         points, dirs)

        density = laplace_density(sdf, beta).reshape(R, S)
        w, _ = render_weights(z_vals, z_max, density)
        rgb_values = (w[..., None] * rgb.reshape(R, S, 3)).sum(1)
        depth = (w * z_vals).sum(1) / torch.clamp(ray_dirs_norm, min=1e-6)
        normals = safe_normalize(grad).reshape(R, S, 3)
        normal_map = safe_normalize((w[..., None] * normals).sum(1))
    return {"rgb_values": rgb_values, "depth_values": depth,
            "weight_sum": w.sum(-1, keepdim=True), "normal_map": normal_map}
