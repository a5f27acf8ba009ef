"""One-bounce indirect light from the trained radiance field (counterpart
of `i2sdf_tpu/models/indirect.py`), plain PyTorch as the JAX package
leaves it to XLA.

* `sphere_trace_hit`: a fixed-count sphere march, returning the hit
  distance and mask;
* `make_field_radiance_fn`: (points, dirs) -> (rgb, hit, hit_pts), the
  radiance net evaluated at the march's hit as the volume renderer
  evaluates it (view direction the query ray's, normals the raw SDF
  gradient);
* `indirect_irradiance`: the cosine-hemisphere estimate of the diffuse
  bounce's irradiance E[Li] from the Hammersley set (`brdf.
  cosine_hemisphere_ld`), emitter hits excluded (the next-event term
  counts them) and escaped rays given the ambient;
* `smooth_irradiance` and `bake_indirect_irradiance`: the material
  trainer's denoise and chunked bake of a buffer of surface samples.

With cosine-weighted directions the estimate of (kd/pi) * int Li <n, l>
dl is kd * mean(Li): the pdf cancels the cosine and the 1/pi. The
samples of a point are marched together (spp x N rows at a time); the
JAX package loops over them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.draws import Draws
from . import mlp
from .brdf import draw_cosine_hemisphere_ld


def sphere_trace_hit(sdf_fn, origins, dirs, t_max, n_steps: int = 48,
                     eps: float = 2e-3, t0: float = 2e-2):
    """March from `origins` along unit `dirs`: a ray whose |sdf| falls
    under eps freezes its t (hit); live rays step by 0.9 |sdf|, at least
    1e-3, up to `t_max`. Returns (t, hit)."""
    n = origins.shape[0]
    t = torch.full((n,), t0, dtype=torch.float32, device=origins.device)
    hit = torch.zeros(n, dtype=torch.bool, device=origins.device)
    for _ in range(n_steps):
        s = sdf_fn(origins + t[:, None] * dirs)
        hit = hit | (s.abs() < eps)
        t_new = torch.clamp(t + torch.clamp(s.abs() * 0.9, min=1e-3),
                            max=t_max)
        t = torch.where(hit, t, t_new)
    return t, hit


def make_field_radiance_fn(model, n_steps: int = 48, t_max: float = 8.0):
    """`(points, dirs) -> (rgb, hit, hit_pts)` of the model's nets (its
    `implicit` and `rendering`, nerf or idr)."""

    def sdf_fn(pts):
        return mlp.sdf_vals(model.implicit, pts)[:, 0]

    def field_fn(points, dirs):
        with torch.no_grad():
            t, hit = sphere_trace_hit(sdf_fn, points, dirs, t_max,
                                      n_steps=n_steps)
            hit_pts = points + t[:, None] * dirs
            _, feat, grad = mlp.sdf_outputs(model.implicit, hit_pts)
            rgb = model.rendering(dirs, feat, hit_pts, grad)
        return rgb, hit, hit_pts

    return field_fn


def indirect_irradiance(field_fn, draws: Draws, points, normals,
                        spp: int = 16, emitter_centers=None,
                        emitter_radii=None, ambient=None,
                        offset: float = 1e-2):
    """One-bounce indirect diffuse irradiance at `points` (N, 3): `spp`
    Hammersley cosine directions a point, each asking `field_fn`; a hit
    within 1.05 radii of an emitter gives 0, an escaped ray `ambient`
    (default 0). kd times the result is the diffuse bounce."""
    n = normals / torch.clamp(torch.linalg.norm(normals, dim=-1,
                                                keepdim=True), min=1e-9)
    origins = points + offset * n
    amb = (points.new_zeros(3) if ambient is None
           else torch.as_tensor(ambient, dtype=torch.float32,
                                device=points.device))
    dirs, _ = draw_cosine_hemisphere_ld(draws, n, spp)
    n_pts = points.shape[0]
    rgb, hit, hit_pts = field_fn(origins.repeat(spp, 1), dirs.reshape(-1, 3))
    li = torch.where(hit[:, None], rgb, amb[None, :])
    if emitter_centers is not None and emitter_centers.shape[0]:
        on_emitter = torch.zeros_like(hit)
        for e in range(emitter_centers.shape[0]):
            d = torch.linalg.norm(hit_pts - emitter_centers[e][None], dim=-1)
            on_emitter |= hit & (d < emitter_radii[e] * 1.05)
        li = torch.where(on_emitter[:, None], 0.0, li)
    li = li.reshape(spp, n_pts, 3)
    total = torch.zeros_like(points)
    for s in range(spp):  # the JAX package's order of the sum
        total = total + li[s]
    return total / spp


def smooth_irradiance(points, normals, e_ind, k: int = 16,
                      radius: float = 0.25, normal_gate: float = 0.7,
                      chunk: int = 1024, query_points=None,
                      query_normals=None, device="cpu") -> np.ndarray:
    """Irradiance-cache denoise of a baked buffer: each query point takes
    the exp(-d^2 / radius^2)-weighted mean of its k nearest baked samples
    whose normals are within `normal_gate` (cosine) of its own. The query
    set defaults to the baked one. Returns numpy (Q, 3)."""
    def unit(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                               min=1e-9)

    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    nrm = unit(normals)
    vals = torch.as_tensor(np.asarray(e_ind, np.float32), device=device)
    if query_points is None:
        qp, qn = pts, nrm
    else:
        qp = torch.as_tensor(np.asarray(query_points, np.float32),
                             device=device)
        qn = unit(query_normals)
    k = min(k, int(pts.shape[0]))
    out = np.empty((qp.shape[0], 3), np.float32)
    for s0 in range(0, qp.shape[0], chunk):
        pc, nc = qp[s0:s0 + chunk], qn[s0:s0 + chunk]
        d2 = ((pc[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        d2 = torch.where(nc @ nrm.T > normal_gate, d2, float("inf"))
        neg_d2, idx = torch.topk(-d2, k, dim=-1)
        w = torch.where(torch.isfinite(neg_d2),
                        torch.exp(neg_d2 / (radius * radius)), 0.0)
        wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        res = torch.einsum("ck,ckd->cd", w, vals[idx]) / wsum
        out[s0:s0 + chunk] = res.cpu().numpy()
    return out


def bake_indirect_irradiance(field_fn, draws: Draws, points, normals,
                             spp: int = 16, emitter_centers=None,
                             emitter_radii=None, ambient=None,
                             chunk: int = 4096, log=None,
                             device=None) -> np.ndarray:
    """`indirect_irradiance` over a large buffer in chunks of `chunk`
    points (the last padded with up-facing normals, its padding rows
    dropped), chunk i on `draws.fold_in(i)`. `device` defaults to the
    draws'. Returns numpy (N, 3)."""
    device = draws.device if device is None else device
    ec = (None if emitter_centers is None else torch.as_tensor(
        emitter_centers, dtype=torch.float32, device=device))
    er = (None if emitter_radii is None else torch.as_tensor(
        emitter_radii, dtype=torch.float32, device=device))
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    n = points.shape[0]
    pad_to = chunk * max(1, math.ceil(n / chunk))
    p = np.pad(points, ((0, pad_to - n), (0, 0)))
    m = np.pad(normals, ((0, pad_to - n), (0, 0)))
    m[n:] = np.array([0.0, 1.0, 0.0], np.float32)
    out = np.empty((pad_to, 3), np.float32)
    for i, s0 in enumerate(range(0, pad_to, chunk)):
        res = indirect_irradiance(
            field_fn, draws.fold_in(i),
            torch.from_numpy(p[s0:s0 + chunk]).to(device),
            torch.from_numpy(m[s0:s0 + chunk]).to(device), spp=spp,
            emitter_centers=ec, emitter_radii=er, ambient=ambient)
        out[s0:s0 + chunk] = res.cpu().numpy()
        if log is not None and (i % 8 == 0 or s0 + chunk >= pad_to):
            log(f"[indirect] baked {min(s0 + chunk, n)}/{n} samples")
    return out[:n]
