"""I2SDF volume renderer (counterpart of `i2sdf_tpu/models/renderer.py`).

`I2SDFModel` holds the SDF net, the radiance net, the learnable beta and,
in the light-mask config, the light net. `render_rays` renders a batch of
rays at eval (`training=False` in the reference): foreground only, with
rgb, depth, the normal map and the light mask, through K1-K3.
`render_rays_train` is the training render (`renderer.py:299-311,
345-394,470-499`); it returns what the losses read (`grad_theta`,
`diff_norm`, `surface_sdf` on the bubble points, `normal_values` under
`use_normal`, `light_mask` with a light head), differentiable with
respect to the model's parameters,
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

The sampler runs K1 and K2 on both routes, and with per-ray compaction
(`ray_sampler.per_ray_exit`) K7 for its convergence checks. Its random
numbers come in a `RenderDraws` bundle.

The light head of the light-mask config (`model.light_network`, JAX
`renderer.py:92-107,185-186`) is an MLP on relu(features) with a sigmoid
output, composited with the weights detached (`renderer.py:464-465`), so
the light loss reaches neither beta nor the SDF through them. It rides
in the render core's kernels on the normal-on route and at eval
(`renderer.py:327-333,363-368`; only the render points' rows, not the
eikonal points', enter the loss), and runs as a plain net on the
features on the normal-off route (`renderer.py:456-462`). With
`model.detach_light_feature` (true by default) its loss reaches the
light net only; without, the SDF net through the features too.

The NeRF++ background (`model.bg_network`, JAX `renderer.py:108-136,
405-444`): the sampler's far depth is the scene sphere's far intersection
and it returns inverse depths for the background; the points on the
inverted sphere (`depth2pts_outside`) go through the background's pair of
MLPs (K8 forward and K9 backward on the card, on every route), with
|sigma| as the density, and `rgb = fg + bg_transmittance * bg`.

Still refused, with a message: idr-mode radiance and the SH/Fourier
encodings.

Compute is f32 in the plain path on either device; on the card the hot
functions run as CUDA kernels with bf16 operands and f32 accumulation
(`ops/kernels/`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..ops.compositing import render_weights, render_weights_bg
from ..ops.kernels import (bg_core, conv_check, render_core, rev,
                           sampler_round, sdf_mlp)
from ..utils.cameras import get_camera_params
from ..utils.jmath import safe_norm, safe_normalize
from .density import abs_density, effective_beta, laplace_density
from .mlp import (ImplicitNet, ImplicitNetConfig, RenderingNet,
                  RenderingNetConfig, clamp_sdf)
from .sampler import (SamplerConfig, SamplerDraws, converged_rays,
                      error_bound_z_vals)


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
    light: ImplicitNetConfig | None = None
    detach_light_feature: bool = True
    bg_implicit: ImplicitNetConfig | None = None
    bg_rendering: RenderingNetConfig | None = None

    @property
    def use_light(self) -> bool:
        return self.light is not None

    @property
    def use_bg(self) -> bool:
        return self.bg_implicit is not None

    @classmethod
    def from_cfgnode(cls, conf: Any) -> "I2SDFConfig":
        """Build from a `model:` config section. Everything is computed in
        f32 (the reference's `compute_dtype` key is not read: its TPU
        default was bf16 matmul operands, which the port's kernels take
        on their own)."""
        rs = conf.ray_sampler
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
        light = None
        if "light_network" in conf:
            ln = conf.light_network
            light = ImplicitNetConfig(
                feature_vector_size=0,
                sdf_bounding_sphere=0.0,
                d_in=fvs,
                d_out=1,
                dims=tuple(ln.dims),
                geometric_init=False,
                skip_in=tuple(ln.get("skip_in", []) or []),
                weight_norm=ln.get("weight_norm", True),
                embed_type=None,
                output_activation="sigmoid",
            )
        bg_implicit = bg_rendering = None
        if "bg_network" in conf:
            bg = conf.bg_network
            bgi, bgr = bg.implicit_network, bg.rendering_network
            bg_implicit = ImplicitNetConfig(
                feature_vector_size=bg.feature_vector_size,
                sdf_bounding_sphere=0.0,
                d_in=bgi.get("d_in", 4),
                d_out=bgi.get("d_out", 1),
                dims=tuple(bgi.dims),
                geometric_init=bgi.get("geometric_init", False),
                skip_in=tuple(bgi.get("skip_in", []) or []),
                weight_norm=bgi.get("weight_norm", True),
                embed_type=bgi.get("embed_type", None),
                multires=bgi.get("multires", 6),
            )
            bg_rendering = RenderingNetConfig(
                feature_vector_size=bg.feature_vector_size,
                mode=bgr.get("mode", "nerf"),
                d_in=bgr.get("d_in", 3),
                d_out=bgr.get("d_out", 3),
                dims=tuple(bgr.dims),
                weight_norm=bgr.get("weight_norm", True),
                embed_type=bgr.get("embed_type", None),
                multires=bgr.get("multires", 4),
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
            inverse_sphere_bg="bg_network" in conf,
            N_samples_inverse_sphere=rs.get("N_samples_inverse_sphere", 32),
            add_tiny=rs.get("add_tiny", 0.0),
            early_exit=rs.get("early_exit", True),
            per_ray_exit=rs.get("per_ray_exit", False),
            # a given tuple pins the capacities at every beta; absent, the
            # trainer and the eval render take them from the beta ladder
            per_ray_fracs=(tuple(rs["per_ray_fracs"])
                           if "per_ray_fracs" in rs else None),
            round_eval_counts=(tuple(rs["round_eval_counts"])
                               if "round_eval_counts" in rs else None),
        )
        return cls(feature_vector_size=fvs, scene_bounding_sphere=sphere,
                   implicit=implicit, rendering=rendering, sampler=sampler,
                   beta_init=conf.density.params_init.beta,
                   beta_min=conf.density.get("beta_min", 1e-4),
                   use_normal=conf.get("use_normal", False), light=light,
                   detach_light_feature=conf.get("detach_light_feature",
                                                 True),
                   bg_implicit=bg_implicit, bg_rendering=bg_rendering)


class I2SDFModel(nn.Module):
    """Parameters of the model: `implicit`, `rendering`, raw `beta`, in
    the light-mask config `light`, and with the NeRF++ background
    `bg_implicit` and `bg_rendering`."""

    def __init__(self, cfg: I2SDFConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.implicit = ImplicitNet(cfg.implicit, gen)
        self.rendering = RenderingNet(cfg.rendering, gen)
        self.beta = nn.Parameter(torch.tensor(cfg.beta_init,
                                              dtype=torch.float32))
        self.light = ImplicitNet(cfg.light, gen) if cfg.use_light else None
        self.bg_implicit = self.bg_rendering = None
        if cfg.use_bg:
            self.bg_implicit = ImplicitNet(cfg.bg_implicit, gen)
            self.bg_rendering = RenderingNet(cfg.bg_rendering, gen)


@dataclasses.dataclass
class KernelWeights:
    """The model's weights in the kernels' layouts, packed once per render
    (weight norm materialized, bf16, mma fragment order)."""
    sdf: sdf_mlp.SdfMlpPack
    core: render_core.RenderCorePack
    bg: bg_core.BgPack | None = None

    @classmethod
    def pack(cls, model: I2SDFModel) -> "KernelWeights":
        return cls(sdf=sdf_mlp.SdfMlpPack(model.implicit),
                   core=render_core.RenderCorePack(
                       model.implicit, model.rendering, model.light),
                   bg=(bg_core.BgPack(model.bg_implicit, model.bg_rendering)
                       if model.cfg.use_bg else None))


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


def _sampler(model: I2SDFModel, sc: SamplerConfig, sdf_pack, plain: bool):
    """`error_bound_z_vals` with the sampler's kernels (their plain
    versions with `plain`)."""
    if plain:
        def sdf_fn(pts):
            return sdf_mlp.sdf_mlp_plain(model.implicit, pts)

        def round_impl(*a):
            return sampler_round.sampler_round_plain(sc, *a)

        def conv_impl(*a):
            return converged_rays(sc, *a)
    else:
        def sdf_fn(pts):
            return sdf_mlp.sdf_mlp_nograd(sdf_pack, pts)

        def round_impl(*a):
            return sampler_round.sampler_round(sc, *a)

        def conv_impl(*a):
            return conv_check.conv_check(sc, *a)

    def sample(ray_dirs, cam_loc, beta0, draws=None):
        return error_bound_z_vals(sc, sdf_fn, ray_dirs, cam_loc, beta0,
                                  round_impl=round_impl, draws=draws,
                                  conv_impl=conv_impl)
    return sample


def depth2pts_outside(ray_o: torch.Tensor, ray_d: torch.Tensor,
                      depth: torch.Tensor, bounding_sphere: float):
    """Points of the NeRF++ inverted-sphere parametrization, (..., 4) =
    [unit direction of the point, inverse distance] (Rodrigues form, JAX
    `renderer.py:193-219`). depth: inverse distance in [0, 1 / sphere]."""
    o_dot_d = (ray_d * ray_o).sum(-1)
    under_sqrt = o_dot_d ** 2 - ((ray_o ** 2).sum(-1) - bounding_sphere ** 2)
    d_sphere = torch.sqrt(torch.clamp(under_sqrt, min=1e-12)) - o_dot_d
    p_sphere = ray_o + d_sphere[..., None] * ray_d
    p_mid = ray_o - o_dot_d[..., None] * ray_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)
    rot_axis = torch.linalg.cross(ray_o, p_sphere, dim=-1)
    rot_axis = rot_axis / torch.clamp(
        torch.linalg.norm(rot_axis, dim=-1, keepdim=True), min=1e-12)
    phi = torch.asin(torch.clamp(p_mid_norm / bounding_sphere, -1.0, 1.0))
    theta = torch.asin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))
    rot_angle = (phi - theta)[..., None]
    p_new = (p_sphere * torch.cos(rot_angle)
             + torch.linalg.cross(rot_axis, p_sphere, dim=-1)
             * torch.sin(rot_angle)
             + rot_axis * (rot_axis * p_sphere).sum(-1, keepdim=True)
             * (1.0 - torch.cos(rot_angle)))
    p_new = p_new / torch.clamp(
        torch.linalg.norm(p_new, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([p_new, depth[..., None]], dim=-1)


def _bg_inputs(cfg: I2SDFConfig, z_vals_bg, ray_dirs, cam_loc):
    """The background's depths flipped (1 / sphere -> 0), its points
    (R * Nbg, 4) on the inverted sphere and their view directions."""
    R, nbg = z_vals_bg.shape
    z_bg = torch.flip(z_vals_bg, dims=[-1])
    dirs = ray_dirs[:, None, :].expand(R, nbg, 3)
    locs = cam_loc[:, None, :].expand(R, nbg, 3)
    x4 = depth2pts_outside(locs, dirs, z_bg, cfg.scene_bounding_sphere)
    return z_bg, x4.reshape(-1, 4).contiguous(), dirs.reshape(-1,
                                                             3).contiguous()


def _bg_composite(z_bg, sigma, rgb):
    """The background's colour per ray from its pair's outputs."""
    R, nbg = z_bg.shape
    w = render_weights_bg(z_bg, abs_density(sigma).reshape(R, nbg))
    return (w[..., None] * rgb.reshape(R, nbg, 3)).sum(1)


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
                      plain: bool = False,
                      sampler: SamplerConfig | None = None) -> dict:
    """Render a batch of rays for a training step.

    inputs as `render_rays`'s, plus an optional "pointcloud" (P, 3) of
    bubble points. The sampler and the kernels of the route (module
    docstring) go through their wrappers: CUDA kernels on CUDA tensors,
    the plain versions on CPU tensors, or the plain versions anywhere
    with `plain=True`. The sampler sees the current weights (packed here)
    and beta, without gradient; `sampler` replaces the model's sampler
    config (the trainer's per-ray capacity phase)."""
    cfg = model.cfg
    with torch.no_grad():
        ray_dirs, cam_loc, ray_dirs_norm = _camera_rays(inputs)
        R = ray_dirs.shape[0]
        beta0 = effective_beta(model.beta.detach(), cfg.beta_min)
        sdf_pack = None if plain else sdf_mlp.SdfMlpPack(model.implicit)
        sample = _sampler(model, sampler or cfg.sampler, sdf_pack, plain)
        z_all, z_vals_bg = sample(ray_dirs, cam_loc, beta0, draws.sampler)
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
    lmask = None
    if returns_grad:
        with torch.no_grad():
            pts_in = torch.cat([points, eik_all]).contiguous()
            dirs_in = torch.cat([dirs, torch.zeros_like(eik_all)]).contiguous()
        w = render_core.CoreWeights.of(model.implicit, model.rendering,
                                       model.light)
        sdf_a, grad_a, rgb_a, *lm_a = render_core.render_core_train(
            cfg.implicit, cfg.rendering, w, pts_in, dirs_in, plain=plain,
            lcfg=cfg.light, detach_light=cfg.detach_light_feature)
        n_main = R * S
        sdf, grad, rgb = sdf_a[:n_main], grad_a[:n_main], rgb_a[:n_main]
        if lm_a:
            lmask = lm_a[0][:n_main]
        grad_theta = grad_a[n_main:]
    else:
        out_main = model.implicit(points)
        sdf = clamp_sdf(cfg.implicit, out_main[:, :1], points)
        rgb = model.rendering(dirs, out_main[:, 1:])
        if cfg.use_light:
            lf = torch.relu(out_main[:, 1:])
            if cfg.detach_light_feature:
                lf = lf.detach()
            lmask = model.light(lf)
        _, _, grad_theta = rev.sdf_outputs_rev(model.implicit,
                                               eik_all.contiguous(),
                                               plain=plain)
    beta = effective_beta(model.beta, cfg.beta_min)
    density = laplace_density(sdf, beta).reshape(R, S)
    weights, bg_trans = render_weights(z_vals, z_max, density)
    rgb_values = (weights[..., None] * rgb.reshape(R, S, 3)).sum(1)
    if cfg.use_bg:
        with torch.no_grad():
            z_bg, x4, bg_dirs = _bg_inputs(cfg, z_vals_bg, ray_dirs, cam_loc)
        sigma, bg_rgb = bg_core.bg_core(
            cfg.bg_implicit, cfg.bg_rendering,
            bg_core.BgWeights.of(model.bg_implicit, model.bg_rendering), x4,
            bg_dirs, plain=plain)
        rgb_values = (rgb_values
                      + bg_trans[:, None] * _bg_composite(z_bg, sigma, bg_rgb))
    out = {
        "rgb_values": rgb_values,
        "depth_values": ((weights * z_vals).sum(1)
                         / torch.clamp(ray_dirs_norm, min=1e-6)),
        "weight_sum": weights.sum(-1, keepdim=True),
    }
    if lmask is not None:
        out["light_mask"] = (weights.detach()[..., None]
                             * lmask.reshape(R, S, 1)).sum(1)
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
                plain: bool = False,
                sampler: SamplerConfig | None = None) -> dict:
    """Render a batch of rays at eval.

    inputs: {"uv": (B, N, 2), "intrinsics": (B, 4, 4), "pose": (B, 4, 4)}.
    The hot functions go through their kernel wrappers, which run the
    CUDA kernel on a CUDA tensor and the plain PyTorch version on a CPU
    tensor; `plain=True` takes the plain versions on any device (used to
    hold the kernels' render against the plain one on the card).
    `weights` are the packed kernel weights (packed here if None);
    `sampler` replaces the model's sampler config (the eval render's
    per-ray capacity phase)."""
    cfg = model.cfg
    if weights is None and not plain:
        weights = KernelWeights.pack(model)
    with torch.no_grad():
        ray_dirs, cam_loc, ray_dirs_norm = _camera_rays(inputs)
        R = ray_dirs.shape[0]
        beta = effective_beta(model.beta, cfg.beta_min)
        sample = _sampler(model, sampler or cfg.sampler,
                          None if plain else weights.sdf, plain)
        z_all, z_vals_bg = sample(ray_dirs, cam_loc, beta)
        z_max = z_all[:, -1]
        z_vals = z_all[:, :-1]
        S = z_vals.shape[1]
        points = (cam_loc[:, None, :]
                  + z_vals[..., None] * ray_dirs[:, None, :]).reshape(-1, 3)
        dirs = ray_dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)

        if plain:
            sdf, grad, rgb, *lmask = render_core.render_core_plain(
                model.implicit, model.rendering, points, dirs, model.light)
        else:
            sdf, grad, rgb, *lmask = render_core.render_core_fwd(
                weights.core, points, dirs)

        density = laplace_density(sdf, beta).reshape(R, S)
        w, bg_trans = render_weights(z_vals, z_max, density)
        rgb_values = (w[..., None] * rgb.reshape(R, S, 3)).sum(1)
        if cfg.use_bg:
            z_bg, x4, bg_dirs = _bg_inputs(cfg, z_vals_bg, ray_dirs, cam_loc)
            if plain:
                sigma, bg_rgb = bg_core.bg_core_plain(
                    cfg.bg_implicit, cfg.bg_rendering,
                    bg_core.BgWeights.of(model.bg_implicit,
                                         model.bg_rendering), x4, bg_dirs)
            else:
                sigma, bg_rgb = bg_core.bg_core_eval(weights.bg, x4, bg_dirs)
            rgb_values = (rgb_values
                          + bg_trans[:, None] * _bg_composite(z_bg, sigma,
                                                              bg_rgb))
        depth = (w * z_vals).sum(1) / torch.clamp(ray_dirs_norm, min=1e-6)
        normals = safe_normalize(grad).reshape(R, S, 3)
        normal_map = safe_normalize((w[..., None] * normals).sum(1))
        out = {"rgb_values": rgb_values, "depth_values": depth,
               "weight_sum": w.sum(-1, keepdim=True),
               "normal_map": normal_map}
        if lmask:
            out["light_mask"] = (w[..., None]
                                 * lmask[0].reshape(R, S, 1)).sum(1)
    return out
