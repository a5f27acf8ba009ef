"""Monte-Carlo direct lighting (counterpart of
`i2sdf_tpu/models/rendering_layer.py`): `shade` importance-samples the
BRDF (cosine-hemisphere diffuse or GGX-VNDF specular events, chosen by
luminance) and asks a caller's `incident_radiance_fn` for the light along
each sample; `shade_emitters` is next-event estimation over sphere
emitters, each sample drawn uniformly inside the emitter's cone.

Both take a `utils.draws.Draws` and walk the JAX key tree: `shade` one
child a sample and three under it (event, diffuse, specular draws;
`rendering_layer.py:58,84` there), `shade_emitters` `fold_in(e)` an
emitter and one child a sample. The JAX package vmaps the samples; here
they are stacked on a leading axis and the radiance or visibility
function is called once on all of them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.draws import Draws
from . import brdf


@dataclasses.dataclass(frozen=True)
class RenderingLayerConfig:
    spp: int = 64
    diffuse_model: str = "lambert"  # 'lambert' | 'disney'
    # Detach the sampling distribution (event choice, directions, pdf)
    # from autograd, differentiating only the BRDF value and the incident
    # radiance: the biased-but-stable estimator of the material trainer.
    # Off for relighting.
    detach_sampling: bool = False


def _stack(draws: Draws, spp: int, shape, device, per_sample: int = 1):
    """The uniforms of `spp` children of `draws` (each split into
    `per_sample` draws of `shape`), stacked: `per_sample` tensors of
    (spp, *shape)."""
    cols = [[] for _ in range(per_sample)]
    for child in draws.split(spp):
        leaves = child.split(per_sample) if per_sample > 1 else [child]
        for col, leaf, shp in zip(cols, leaves, shape):
            col.append(leaf.uniform(shp).to(device))
    return [torch.stack(c) for c in cols]


def shade(cfg: RenderingLayerConfig, draws: Draws, points, normals,
          view_dirs, kd, ks, roughness, incident_radiance_fn):
    """Diffuse and specular outgoing radiance at each point by BRDF
    sampling. points, normals, view_dirs, kd, ks: (N, 3); roughness (N,);
    `incident_radiance_fn(points, dirs) -> (M, 3)`. Returns
    {color_diffuse, color_specular} (N, 3)."""
    n_pts, spp = points.shape[0], cfg.spp
    if cfg.detach_sampling:
        kd_s, ks_s, rough_s = kd.detach(), ks.detach(), roughness.detach()
    else:
        kd_s, ks_s, rough_s = kd, ks, roughness
    p_spec = brdf.specular_event_probability(kd_s, ks_s)
    ev, u_diff, u_spec = _stack(draws, spp, ((n_pts,), (n_pts, 2),
                                             (n_pts, 2)),
                                points.device, per_sample=3)
    nrm = normals.expand(spp, *normals.shape)
    vd = view_dirs.expand(spp, *view_dirs.shape)
    l_diff, _ = brdf.sample_cosine_hemisphere(u_diff, nrm)
    l_spec, _ = brdf.sample_ggx_vndf(u_spec, nrm, vd, rough_s)
    l = torch.where((ev < p_spec)[..., None], l_spec, l_diff)
    cos_l = torch.clamp((nrm * l).sum(-1), 0.0, 1.0)
    pdf = brdf.combined_pdf(kd_s, ks_s, rough_s, nrm, vd, l)
    li = incident_radiance_fn(points.repeat(spp, 1),
                              l.reshape(-1, 3)).reshape(spp, n_pts, 3)
    w = (cos_l / torch.clamp(pdf, min=1e-6))[..., None]
    diff_f = brdf.eval_diffuse(cfg.diffuse_model, kd, roughness, nrm, vd, l,
                               cos_l)
    spec_f = brdf.eval_ggx_specular(ks, roughness, nrm, vd, l)
    valid = (cos_l > 0)[..., None]
    return {
        "color_diffuse": torch.where(valid, li * diff_f * w, 0.0).mean(0),
        "color_specular": torch.where(valid, li * spec_f * w, 0.0).mean(0),
    }


def shade_emitters(cfg: RenderingLayerConfig, draws: Draws, points, normals,
                   view_dirs, kd, ks, roughness, centers, radii, radiance,
                   visibility_fn=None):
    """Direct light from sphere emitters by next-event estimation: each
    sample uniform inside the emitter's cone (a guaranteed hit), weighted
    by the cone's solid angle. centers (E, 3), radii (E,), radiance (E,
    3); `visibility_fn(points, dirs, t_max) -> (M,)` in [0, 1], None for
    unoccluded. `cfg.detach_sampling` does not apply: the cone pdf is
    emitter geometry alone. Returns {color_diffuse, color_specular}."""
    n_pts, spp = points.shape[0], cfg.spp
    diff_total = torch.zeros_like(kd)
    spec_total = torch.zeros_like(kd)
    nrm = normals.expand(spp, *normals.shape)
    vd = view_dirs.expand(spp, *view_dirs.shape)
    for e in range(centers.shape[0]):
        to_c = centers[e] - points
        dist = torch.linalg.norm(to_c, dim=-1)
        axis = to_c / torch.clamp(dist, min=1e-9)[:, None]
        sin_h = torch.clamp(radii[e] / torch.clamp(dist, min=1e-9), 0.0, 1.0)
        inside = dist < radii[e]
        # inside the emitter every direction leaves through it: the whole
        # sphere (cos_half = -1)
        cos_h = torch.where(inside, -1.0,
                            torch.sqrt(torch.clamp(1.0 - sin_h ** 2,
                                                   min=0.0)))
        (u,) = _stack(draws.fold_in(e), spp, ((n_pts, 2),), points.device)
        l, pdf = brdf.sample_uniform_cone(u, axis, cos_h)
        cos_l = torch.clamp((nrm * l).sum(-1), 0.0, 1.0)
        if visibility_fn is None:
            vis = torch.ones_like(cos_l)
        else:
            # march to just before the emitter's surface: the cone
            # guarantees a hit, so the first root bounds the march
            oc = points - centers[e]
            b = (oc * l).sum(-1)
            c = (oc * oc).sum(-1) - radii[e] ** 2
            disc = torch.clamp(b * b - c, min=0.0)
            t_hit = torch.clamp(-b - torch.sqrt(disc), min=1e-3)
            vis = visibility_fn(points.repeat(spp, 1), l.reshape(-1, 3),
                                (t_hit * 0.98).reshape(-1)).reshape(spp,
                                                                    n_pts)
            vis = torch.where(inside, 1.0, vis)
        w = (cos_l / pdf * vis)[..., None]
        diff_f = brdf.eval_diffuse(cfg.diffuse_model, kd, roughness, nrm, vd,
                                   l, cos_l)
        spec_f = brdf.eval_ggx_specular(ks, roughness, nrm, vd, l)
        valid = (cos_l > 0)[..., None]
        li = radiance[e][None, :]
        diff_total = diff_total + torch.where(valid, li * diff_f * w,
                                              0.0).mean(0)
        spec_total = spec_total + torch.where(valid, li * spec_f * w,
                                              0.0).mean(0)
    return {"color_diffuse": diff_total, "color_specular": spec_total}
