"""Relighting (counterpart of `i2sdf_tpu/eval/relight.py`): Monte-Carlo
direct light on the trained SDF scene under edited materials and
emitters, `--test_mode relight` and `relight_video`.

1. Geometry: the eval render's expected depth and normal map a pixel
   (`train/step.py::make_eval_render_fn`: K1, K2 and K3, or K3 with the
   light head, on the card).
2. Emitters: the light-mask pixels unprojected by GT depth
   (`data/recon.depth_to_world`), the brightest 0.2 % of pixels where no
   mask is lit, or without GT masks and depth the model's own light head
   and rendered depth (`find_emitters_from_model`); clustered by
   K-Means++ (`ops/clustering.py`, the subsample
   `default_rng(0).permutation` as in the JAX package) into sphere
   emitters: radius the 0.9-quantile distance to the centroid, radiance
   the mean pixel colour; `emission_scale` in the edit config rescales
   them.
3. Materials: kd the rendered colour clipped to [0, 1], ks 0.04,
   roughness 0.5, or with a trained material stage (`--use_material`,
   `train/material.py::load_material_stage`) the material net's kd, ks
   and roughness at the surface points, its emitters with their learned
   emission in place of the discovered ones and its learned ambient
   added; then the edit config's override maps (`data/relight.py`).
4. Shading: next-event estimation over the emitters
   (`models/rendering_layer.shade_emitters`), visibility sphere-traced
   through the plain SDF net with the emitter balls carved out, in chunks
   of 4,096 points; with `indirect_spp` one diffuse bounce from the
   trained radiance field (`models/indirect.py`). Pixels on an emitter
   show its radiance.

Random draws walk the JAX key tree (`utils/draws.py`): a child a view,
one a chunk, split into the emitters' and the bounce's. Outputs keep the
JAX names, `{tag}_relit.png`, `_diffuse.png`, `_specular.png` (sRGB), and
the linear relit image as `{tag}_relit.exr` (ZIP, FLOAT: the JAX native
writer's bytes, `utils/exr.write_exr`; a failed write fails the run).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.plot import PlotData
from ..data.recon import ReconData, depth_to_world
from ..data.relight import RelightData, RelightVideoData
from ..models import mlp
from ..models.indirect import indirect_irradiance, make_field_radiance_fn
from ..models.material import ambient_apply
from ..models.rendering_layer import RenderingLayerConfig, shade_emitters
from ..ops.clustering import init_emission_groups
from ..train.step import make_eval_render_fn
from ..utils import exr, imaging
from ..utils.cameras import get_camera_params
from ..utils.draws import Draws
from .interpolate import frames_to_video


class Emitters:
    """Sphere emitters: centers (E, 3), radii (E,), radiance (E, 3), f32
    tensors on one device."""

    def __init__(self, centers, radii, radiance, device=None):
        self.centers, self.radii, self.radiance = (
            torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in (centers, radii, radiance))

    @property
    def count(self) -> int:
        return int(self.centers.shape[0])


def find_emitters(rd: ReconData, n_emitters: int = 1,
                  emitter_scale: float = 1.0, mask_thresh: float = 0.5,
                  max_points: int = 50_000, draws: Draws | None = None,
                  device="cpu") -> Emitters:
    """Cluster the light-mask pixels above `mask_thresh`, unprojected by GT
    depth, into sphere emitters with their pixels' mean colour; where no
    view has one, the brightest 0.2 % of pixels. Raises ValueError without
    light masks or depth."""
    if rd.lightmask_images is None:
        raise ValueError("relight needs a light_mask dataset "
                         "(dataset has none)")
    if rd.depth_images is None:
        raise ValueError("relight needs GT depth to place emitters")

    def collect(selector):
        pts, rgbs = [], []
        for i in range(rd.n_images):
            sel = selector(i) & np.asarray(rd.depth_masks[i]).reshape(-1)
            if not sel.any():
                continue
            pts.append(depth_to_world(rd.uv, rd.intrinsics_all[i],
                                      rd.pose_all[i], rd.depth_images[i],
                                      sel))
            rgbs.append(np.asarray(rd.rgb_images[i]).reshape(-1, 3)[sel])
        return pts, rgbs

    pts, rgbs = collect(lambda i: np.asarray(
        rd.lightmask_images[i]).reshape(-1) > mask_thresh)
    if not pts:
        lum = np.asarray(rd.rgb_images).reshape(rd.n_images, -1, 3).mean(-1)
        cut = np.quantile(lum, 0.998)
        print("[relight] WARN: no light-mask pixels above threshold; "
              f"falling back to brightest pixels (luminance > {cut:.3f})")
        pts, rgbs = collect(lambda i: lum[i] >= cut)
    if not pts:
        raise ValueError("no emitter pixels found; cannot build emitters")
    return _cluster_emitters(np.concatenate(pts), np.concatenate(rgbs),
                             n_emitters, emitter_scale, max_points,
                             draws or Draws.seeded(0, device), device)


def _cluster_emitters(pts, rgbs, n_emitters, emitter_scale, max_points,
                      draws, device) -> Emitters:
    """K-Means++ of the candidate points into emitters: radius the
    0.9-quantile distance to the centroid (at least 1e-3), radiance the
    mean colour times `emitter_scale`; an empty cluster a dark 1e-3 one."""
    if len(pts) > max_points:
        idx = np.random.default_rng(0).permutation(len(pts))[:max_points]
        pts, rgbs = pts[idx], rgbs[idx]
    labels, centers, _ = init_emission_groups(
        draws, torch.as_tensor(np.asarray(pts, np.float32), device=device),
        n_emitters)
    labels = labels.cpu().numpy()
    centers = centers.cpu().numpy()
    radii = np.empty(n_emitters, np.float32)
    radiance = np.empty((n_emitters, 3), np.float32)
    for e in range(n_emitters):
        sel = labels == e
        if not sel.any():
            radii[e], radiance[e] = 1e-3, 0.0
            continue
        d = np.linalg.norm(pts[sel] - centers[e], axis=-1)
        radii[e] = max(float(np.quantile(d, 0.9)), 1e-3)
        radiance[e] = rgbs[sel].mean(0) * emitter_scale
    return Emitters(centers, radii, radiance, device)


def sphere_trace_visibility(sdf_fn, origins, dirs, t_max, n_steps: int = 32,
                            eps: float = 2e-3, t0: float = 2e-2):
    """1 where the segment [t0, t_max] is unoccluded, else 0: a sphere
    march whose step is floored at t_max / n_steps, so it spans the
    segment in `n_steps`, and occluded where its closest approach came
    within eps of a surface (min sampled sdf <= eps)."""
    t_max = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32,
                                        device=origins.device), min=t0)
    floor = t_max / n_steps
    t = torch.full(origins.shape[:1], t0, dtype=torch.float32,
                   device=origins.device)
    min_s = torch.full_like(t, float("inf"))
    for _ in range(n_steps):
        s = sdf_fn(origins + t[:, None] * dirs)
        min_s = torch.minimum(min_s, s)
        t = torch.minimum(t + torch.maximum(s, floor), t_max)
    return (min_s > eps).to(torch.float32)


def _view_points(out, uv, K, pose):
    """The render's surface points (depth times the ray's norm along the
    unit ray), the unit rays and the camera's position."""
    ray_dirs, cam_loc = get_camera_params(uv[None], pose[None], K[None])
    norms = torch.linalg.norm(ray_dirs[0], dim=-1, keepdim=True)
    units = ray_dirs[0] / torch.clamp(norms, min=1e-12)
    dist = out["depth_values"].reshape(-1) * norms[:, 0]
    return cam_loc[0][None, :] + dist[:, None] * units, units


def find_emitters_from_model(render_image, pd, n_emitters: int = 1,
                             emitter_scale: float = 1.0,
                             mask_thresh: float | None = None,
                             rel_thresh: float = 0.5, min_mask: float = 0.02,
                             max_points: int = 50_000,
                             draws: Draws | None = None,
                             device="cpu") -> Emitters:
    """Emitters from the model's own light head: the rendered light mask
    marks emissive pixels (above `rel_thresh` of its maximum over pixels
    of weight sum > 0.5, at least `min_mask`; or above `mask_thresh`) and
    the rendered depth unprojects them; radiance the rendered colour. At
    most 16 views of `pd` (evenly spaced). Needs a model with a light
    head."""
    max_views = 16
    if pd.n_images > max_views:
        view_ids = np.linspace(0, pd.n_images - 1, max_views).astype(int)
        print(f"[relight] model-head discovery over {max_views} of "
              f"{pd.n_images} views")
    else:
        view_ids = range(pd.n_images)
    views = []
    for i in view_ids:
        uv, K, pose, _ = (torch.from_numpy(np.asarray(a)).to(device)
                          for a in pd.image_inputs(i))
        with torch.no_grad():
            out = render_image(uv, K, pose)
        if "light_mask" not in out:
            raise ValueError("find_emitters_from_model needs a model "
                             "with a light_network head")
        p, _ = _view_points(out, uv, K, pose)
        views.append((out["light_mask"].reshape(-1).cpu().numpy(),
                      out["weight_sum"].reshape(-1).cpu().numpy(),
                      p.cpu().numpy(),
                      out["rgb_values"].reshape(-1, 3).cpu().numpy()))
    if mask_thresh is None:
        # the maximum over eligible pixels (weight sum > 0.5, the
        # selection's own gate)
        gmax = 0.0
        for lm, wsum, _, _ in views:
            elig = lm[wsum > 0.5]
            if elig.size:
                gmax = max(gmax, float(elig.max()))
        mask_thresh = max(min_mask, rel_thresh * gmax)
    pts, rgbs = [], []
    for lm, wsum, p, rgb in views:
        sel = (lm > mask_thresh) & (wsum > 0.5)
        if sel.any():
            pts.append(p[sel])
            rgbs.append(rgb[sel])
    if not pts:
        raise ValueError(
            "model predicts no emissive pixels above "
            f"{mask_thresh:.3f} in any view (is the light head trained?)")
    return _cluster_emitters(np.concatenate(pts), np.concatenate(rgbs),
                             n_emitters, emitter_scale, max_points,
                             draws or Draws.seeded(0, device), device)


# the emitter balls' margin: `carve_emitters_sdf`'s free space, and the
# material trainer's exclusion of baked points, which must agree
EMITTER_MARGIN = 0.05


def carve_emitters_sdf(sdf_fn, centers, radii, margin: float = EMITTER_MARGIN):
    """`sdf_fn` with every emitter ball (plus `margin`) read as free space:
    an emitter found on a surface must not shadow its own light."""
    def carved(pts):
        s = sdf_fn(pts)
        for e in range(centers.shape[0]):
            s = torch.maximum(s, radii[e] + margin - torch.linalg.norm(
                pts - centers[e][None], dim=-1))
        return s

    return carved


def incident_radiance(sdf_fn, centers, radii, radiance, points, dirs,
                      n_steps: int = 32):
    """(N, 3) light arriving at `points` along `dirs`: each emitter's
    radiance where the ray meets its sphere (or starts inside it), gated
    by the visibility through the carved SDF. `radiance` stays live for
    autograd (the material trainer learns the emission through it)."""
    sdf_fn = carve_emitters_sdf(sdf_fn, centers, radii)
    total = torch.zeros_like(points)
    for e in range(centers.shape[0]):
        oc = points - centers[e]
        b = (oc * dirs).sum(-1)
        c = (oc * oc).sum(-1) - radii[e] ** 2
        disc = b * b - c
        t_hit = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        inside = c < 0.0
        hits = ((disc > 0.0) & (t_hit > 1e-3)) | inside
        t_cap = torch.where(hits, torch.clamp(t_hit * 0.98, min=1e-3), 1e-3)
        vis = sphere_trace_visibility(sdf_fn, points, dirs, t_cap,
                                      n_steps=n_steps)
        vis = torch.where(inside, 1.0, vis)
        total = total + radiance[e][None, :] * hits[:, None] * vis[:, None]
    return total


def make_incident_radiance_fn(sdf_fn, emitters: Emitters, n_steps: int = 32):
    """(points, dirs) -> (N, 3) incident radiance of a fixed emitter set."""
    def li(points, dirs):
        return incident_radiance(sdf_fn, emitters.centers, emitters.radii,
                                 emitters.radiance, points, dirs,
                                 n_steps=n_steps)

    return li


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class RelightContext:
    """What the relight renderers share: the eval render, the emitter set
    (GT masks and depth, else the model's light head; then the edit
    config's `emission_scale`), the carved visibility and the shading of
    one chunk. `seconds` sums the stages' wall time (synchronized on the
    card): geometry (the eval render), nee (next-event shading with its
    visibility), indirect (the field bounce)."""

    def __init__(self, model, conf, data_root: str, n_emitters: int,
                 emitter_scale: float, spp: int, vis_steps: int,
                 fused: bool = True, full_res: bool = False,
                 edit_conf: dict | None = None,
                 indirect_spp: int | None = None,
                 emitter_draws: Draws | None = None, material=None):
        self.device = device = next(model.parameters()).device
        dataset_conf = dict(conf.dataset)
        self.scan_id = dataset_conf.pop("scan_id", 0)
        ds = dataset_conf.pop("downsample", 1)
        self.downsample = 1 if full_res else ds
        dataset_conf.pop("data_root", None)
        self.dataset_conf = dataset_conf
        self.seconds = dict(geometry=0.0, nee=0.0, indirect=0.0)
        self.render_image = make_eval_render_fn(
            model, chunk_size=conf.train.get("split_n_pixels", 12000),
            fused=fused)
        emitter_draws = emitter_draws or Draws.seeded(0, device)
        self.material = material
        if material is not None:
            self.emitters = material[2]
            print("[relight] using trained material stage; "
                  f"{self.emitters.count} emitters with learned emission")
        else:
            try:
                rd = ReconData(dataset_conf["data_dir"],
                               scan_id=self.scan_id, data_root=data_root,
                               use_depth=True, use_lightmask=True)
                self.emitters = find_emitters(
                    rd, n_emitters=n_emitters, emitter_scale=emitter_scale,
                    draws=emitter_draws, device=device)
            except (ValueError, AssertionError, FileNotFoundError) as e:
                # no GT light masks or depth: the model's own light head
                # and rendered depth (a light-mask model only)
                if model.light is None:
                    raise
                print(f"[relight] GT-mask emitter discovery failed ({e}); "
                      "falling back to the model's light head")
                pd0 = PlotData(scan_id=self.scan_id, data_root=data_root,
                               downsample=self.downsample, **dataset_conf)
                self.emitters = find_emitters_from_model(
                    self.render_image, pd0, n_emitters=n_emitters,
                    emitter_scale=emitter_scale, draws=emitter_draws,
                    device=device)
        if edit_conf and edit_conf.get("emission_scale") is not None:
            s = torch.as_tensor(edit_conf["emission_scale"],
                                dtype=torch.float32, device=device)
            self.emitters = Emitters(self.emitters.centers,
                                     self.emitters.radii,
                                     self.emitters.radiance * s, device)
            print(f"[relight] emission_scale applied: {s.tolist()}")
        print(f"[relight] {self.emitters.count} emitters; centers="
              f"{np.round(self.emitters.centers.cpu().numpy(), 3).tolist()}")

        def sdf_fn(pts):
            return mlp.sdf_vals(model.implicit, pts)[:, 0]

        vis_sdf = carve_emitters_sdf(sdf_fn, self.emitters.centers,
                                     self.emitters.radii)
        self.vis_fn = lambda pts, dirs, t_max: sphere_trace_visibility(
            vis_sdf, pts, dirs, t_max, n_steps=vis_steps)
        # the learned ambient irradiance of a trained material stage
        self.ambient = (ambient_apply(material[0].emission).detach()
                        if material is not None
                        else torch.zeros(3, device=device))
        self.layer_cfg = RenderingLayerConfig(spp=spp)
        if indirect_spp is None:
            indirect_spp = int((conf.get("material", {}) or {})
                               .get("indirect_spp", 0))
        self.indirect_spp = indirect_spp
        self.field_fn = None
        if indirect_spp > 0:
            self.field_fn = make_field_radiance_fn(model)
            print(f"[relight] one-bounce field indirect at {indirect_spp} "
                  "spp")

    def shade_chunk(self, draws: Draws, pts, normals, view_dirs, kd, ks,
                    rough) -> dict:
        """Next-event shading of one chunk, plus kd times the ambient and
        (with `indirect_spp`) the field bounce's irradiance."""
        em = self.emitters
        k_nee, k_ind = draws.split(2)
        t0 = time.perf_counter()
        out = shade_emitters(self.layer_cfg, k_nee, pts, normals, view_dirs,
                             kd, ks, rough, em.centers, em.radii,
                             em.radiance, visibility_fn=self.vis_fn)
        _sync(self.device)
        t1 = time.perf_counter()
        self.seconds["nee"] += t1 - t0
        irr = self.ambient[None].expand(pts.shape)
        if self.indirect_spp > 0:
            irr = irr + indirect_irradiance(
                self.field_fn, k_ind, pts, normals, spp=self.indirect_spp,
                emitter_centers=em.centers, emitter_radii=em.radii)
            _sync(self.device)
            self.seconds["indirect"] += time.perf_counter() - t1
        out["color_diffuse"] = out["color_diffuse"] + kd * irr
        return out

    @torch.no_grad()
    def view_inputs(self, pd: RelightData, uv, K, pose,
                    render_image=None) -> list:
        """One camera's shading inputs [points, unit normals, view dirs,
        kd, ks, roughness] on the device: the geometry of the eval render
        (`render_image`, by default the context's), the default materials
        (or the trained material net's at the points) under `pd`'s edit
        maps."""
        dev = self.device
        uv, K, pose = (torch.from_numpy(np.asarray(a)).to(dev)
                       for a in (uv, K, pose))
        t0 = time.perf_counter()
        out = (render_image or self.render_image)(uv, K, pose)
        _sync(dev)
        self.seconds["geometry"] += time.perf_counter() - t0
        pts, units = _view_points(out, uv, K, pose)
        if self.material is not None:
            m = self.material[0].material(pts)
            kd, ks, rough = (m[k].cpu().numpy()
                             for k in ("kd", "ks", "rough"))
        else:
            kd = np.clip(out["rgb_values"].reshape(-1, 3).cpu().numpy(),
                         0, 1)
            ks = np.full_like(kd, 0.04)
            rough = np.full(kd.shape[0], 0.5, np.float32)
        mats = pd.edited_materials(
            kd, ks, rough[:, None],
            out["normal_map"].reshape(-1, 3).cpu().numpy())
        normals = torch.from_numpy(np.asarray(mats["normal"], np.float32)
                                   ).to(dev)
        normals = normals / torch.clamp(torch.linalg.norm(
            normals, dim=-1, keepdim=True), min=1e-9)
        return [pts, normals, -units] + [
            torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in (mats["kd"], mats["ks"], mats["rough"].reshape(-1))]

    def paint_emitters(self, pts, relit):
        """A pixel on an emitter shows its (edited) radiance, at the exact
        cluster radius."""
        em = self.emitters
        for e in range(em.count):
            on = torch.linalg.norm(pts - em.centers[e], dim=-1) < em.radii[e]
            relit = torch.where(on[:, None], em.radiance[e][None], relit)
        return relit

    @torch.no_grad()
    def shade_view(self, pd: RelightData, uv, K, pose, draws: Draws,
                   chunk: int = 4096):
        """Geometry of one camera, its (edited) materials, and their
        shading in chunks of `chunk` points (the last zero-padded, as the
        JAX package pads it, so the chunks' draws have its shapes).
        Returns numpy (relit, diffuse, specular), flat (HW, 3), linear."""
        cols = self.view_inputs(pd, uv, K, pose)
        n = cols[0].shape[0]
        diff = torch.empty((n, 3), device=self.device)
        spec = torch.empty((n, 3), device=self.device)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            draws, k = draws.split(2)
            o = self.shade_chunk(k, *(torch.cat([a[s:e], a.new_zeros(
                (chunk - (e - s),) + a.shape[1:])]) for a in cols))
            diff[s:e] = o["color_diffuse"][: e - s]
            spec[s:e] = o["color_specular"][: e - s]
        relit = self.paint_emitters(cols[0], diff + spec)
        return relit.cpu().numpy(), diff.cpu().numpy(), spec.cpu().numpy()


def _write_srgb(path: str, img: np.ndarray) -> None:
    imaging.write_png(path, imaging.to_u8(np.clip(
        imaging.linear_to_srgb(img), 0, 1)))


def run_relight(model, conf, exp_dir: str, data_root: str = "data",
                indices=None, spp: int = 16, n_emitters: int = 1,
                emitter_scale: float = 1.0, edit_conf: dict | None = None,
                fused: bool = True, full_res: bool = False,
                chunk: int = 4096, vis_steps: int = 32, seed: int = 0,
                indirect_spp: int | None = None, draws: Draws | None = None,
                emitter_draws: Draws | None = None, material=None) -> dict:
    """Relit images of every view (or `indices`) into `eval/relight/`:
    `{tag}_relit.png`, `_diffuse.png`, `_specular.png` and the linear
    `{tag}_relit.exr`. `draws` defaults to a generator seeded with `seed`
    on the model's device, `emitter_draws` (the clustering's) to one
    seeded with 0, as the JAX package's keys. `material`: a trained
    stage, `(MaterialStage, MaterialNetConfig, Emitters)` from
    `train/material.py::load_material_stage`, whose materials, emitters
    and ambient replace the defaults. Returns the emitter count, each
    image's mean radiance and stage seconds, and the output directory."""
    ctx = RelightContext(model, conf, data_root, n_emitters, emitter_scale,
                         spp, vis_steps, fused, full_res, edit_conf,
                         indirect_spp, emitter_draws, material)
    pd = RelightData(scan_id=ctx.scan_id, data_root=data_root,
                     downsample=ctx.downsample, indices=indices,
                     edit_conf=edit_conf, **ctx.dataset_conf)
    out_dir = os.path.join(exp_dir, "eval", "relight")
    os.makedirs(out_dir, exist_ok=True)
    H, W = pd.img_res
    draws = draws or Draws.seeded(seed, ctx.device)
    results = []
    for row, idx in enumerate(pd.indices):
        uv, K, pose, _ = pd.image_inputs(row)
        draws, k = draws.split(2)
        before = dict(ctx.seconds)
        relit, diff, spec = ctx.shade_view(pd, uv, K, pose, k, chunk)
        t0 = time.perf_counter()
        tag = f"{idx:04d}"
        for name, img in (("relit", relit), ("diffuse", diff),
                          ("specular", spec)):
            _write_srgb(os.path.join(out_dir, f"{tag}_{name}.png"),
                        img.reshape(H, W, 3))
        exr.write_exr(os.path.join(out_dir, f"{tag}_relit.exr"),
                      relit.reshape(H, W, 3))
        seconds = {k: ctx.seconds[k] - before[k] for k in before}
        seconds["writes"] = time.perf_counter() - t0
        results.append({"idx": idx, "mean_radiance": float(relit.mean()),
                        "seconds": seconds})
        print(f"[relight {tag}] mean={relit.mean():.4f} seconds="
              + " ".join(f"{k}:{v:.3f}" for k, v in seconds.items()))
    return {"emitters": ctx.emitters.count, "images": results,
            "out_dir": out_dir}


def run_relight_video(model, conf, exp_dir: str, id0: int = 0, id1: int = 1,
                      n_frames: int = 60, frame_rate: int = 24,
                      data_root: str = "data", spp: int = 16,
                      n_emitters: int = 1, emitter_scale: float = 1.0,
                      edit_conf: dict | None = None, fused: bool = True,
                      full_res: bool = False, chunk: int = 4096,
                      vis_steps: int = 32, seed: int = 0,
                      indirect_spp: int | None = None,
                      draws: Draws | None = None,
                      emitter_draws: Draws | None = None,
                      material=None) -> dict:
    """A relit flythrough from view id0's pose to id1's: `n_frames` PNG
    frames in `eval/relight_video/{id0:04d}_{id1:04d}/` and, with ffmpeg on
    the path, `relight_{id0:04d}_{id1:04d}.mp4` beside them (`material`
    as in `run_relight`)."""
    ctx = RelightContext(model, conf, data_root, n_emitters, emitter_scale,
                         spp, vis_steps, fused, full_res, edit_conf,
                         indirect_spp, emitter_draws, material)
    pd = RelightVideoData(scan_id=ctx.scan_id, data_root=data_root,
                          downsample=ctx.downsample, edit_conf=edit_conf,
                          id0=id0, id1=id1, num_frames=n_frames,
                          **ctx.dataset_conf)
    video_dir = os.path.join(exp_dir, "eval", "relight_video")
    frame_dir = os.path.join(video_dir, f"{id0:04d}_{id1:04d}")
    os.makedirs(frame_dir, exist_ok=True)
    H, W = pd.img_res
    draws = draws or Draws.seeded(seed, ctx.device)
    means = []
    for i in range(pd.num_frames):
        uv, K, pose = pd.frame_inputs(i)
        draws, k = draws.split(2)
        relit, _, _ = ctx.shade_view(pd, uv, K, pose, k, chunk)
        _write_srgb(os.path.join(frame_dir, f"{i:04d}.png"),
                    relit.reshape(H, W, 3))
        means.append(float(relit.mean()))
        print(f"[relight-video {i + 1}/{pd.num_frames}] mean={means[-1]:.4f}")
    mp4 = os.path.join(video_dir, f"relight_{id0:04d}_{id1:04d}.mp4")
    wrote = frames_to_video(frame_dir, mp4, frame_rate)
    return {"emitters": ctx.emitters.count, "frames": pd.num_frames,
            "frame_dir": frame_dir, "mean_radiance": means,
            "mp4": mp4 if wrote else None, "seconds": dict(ctx.seconds)}
