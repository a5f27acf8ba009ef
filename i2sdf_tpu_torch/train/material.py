"""Material stage (counterpart of `i2sdf_tpu/train/material.py`): on a
frozen reconstruction, learn a spatial material field (kd, ks, roughness;
`models/material.py`) and each emitter's emission so that next-event
shading of the frozen geometry reproduces the observed images.

1. Geometry is baked once: every training pixel's surface point, normal
   and view direction from the eval render (`train/step.py::
   make_eval_render_fn`: K1, K2 and K3, with the light head on the
   light-mask config, on the card), the points then Newton-projected
   onto the SDF's zero level set twice (the plain f32 net and its
   autograd gradient, in 8,192-point padded chunks), the points inside
   an emitter ball (plus `EMITTER_MARGIN`) dropped; with `indirect_spp`
   the one-bounce field irradiance baked and k-NN smoothed
   (`models/indirect.py`).
2. A step gathers `batch_size` baked samples, shades them twice at
   spp / 2 (two independent buffers: the dual-buffer estimator, each
   residual detached and multiplied by the other buffer's prediction),
   adds the smoothness, ks-prior and ambient-prior terms, and takes one
   Adam step (eps 1e-15, the update of step t at lr(t) of `train/state.
   make_lr_schedule` with `decay_steps = steps`). Emitter visibility is a
   `vis_steps` sphere march through the frozen SDF with the emitter balls
   carved out (`eval/relight.py`); on the card that SDF is K1
   (`ops/kernels/sdf_mlp.sdf_mlp_nograd`) on a pack built once from the
   frozen net, elsewhere or with `fused=False` the plain net. It carries
   no gradient: kd, ks, roughness and the emission learn through the
   BRDF values and the radiance only.
3. `calibrate` rescales the initial emission (and the ambient, unless a
   bounce was baked) by a probe render's per-channel ratio to the
   observed mean before the optimizer is built.

Random draws walk the JAX key tree (`utils/draws.py`): the trainer's own
draws (`Draws.seeded(seed)`, JAX's `PRNGKey(seed)`) for the emitters, the
bounce, the init's split, the calibration and the plots; step t's from
`train/step.step_generator(seed + 1, t)`, so a resumed fit replays an
uninterrupted one. Outputs under `<exp_dir>/material/`: `emitters.npz`,
`checkpoints/step_N.pt` (`train/checkpoint.py`) and `plots/` (`kd_`,
`rough_`, `render_`). A log line every `log_freq` steps takes the place
of the JAX trainer's TensorBoard writer; its multi-device data
parallelism is not here.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..data.material import MaterialData
from ..data.recon import ReconData
from ..eval.relight import (EMITTER_MARGIN, Emitters, carve_emitters_sdf,
                            find_emitters, sphere_trace_visibility)
from ..models import mlp
from ..models.material import (MaterialNetConfig, MaterialStage,
                               ambient_apply, emission_apply)
from ..models.rendering_layer import RenderingLayerConfig, shade_emitters
from ..ops.kernels import sdf_mlp
from ..utils import imaging
from ..utils.cameras import get_camera_params
from ..utils.draws import Draws
from . import artifacts
from .checkpoint import CheckpointManager
from .state import create_train_state
from .step import make_eval_render_fn, step_generator


@dataclasses.dataclass(frozen=True)
class MaterialTrainConfig:
    """The JAX package's fields and defaults (their reasons are given
    there, `i2sdf_tpu/train/material.py:57-140`)."""
    steps: int = 20_000
    batch_size: int = 2048
    learning_rate: float = 5e-4
    decay_rate: float = 0.1
    spp: int = 8
    vis_steps: int = 24
    smooth_weight: float = 0.01
    smooth_eps: float = 0.01  # world-space jitter of the smoothness pair
    smooth_ks_weight: float = 0.0
    ks_prior: float = 0.04
    ks_prior_weight: float = 0.01
    ambient_prior_weight: float = 0.01
    relative_mse: bool = True
    relative_mse_eps: float = 0.1
    relative_mse_pow: float = 2.0
    project_surface: bool = True
    calibrate_emission: bool = True
    indirect_spp: int = 0
    indirect_steps: int = 48
    indirect_chunk: int = 4096
    indirect_smooth_k: int = 16
    n_emitters: int = 1
    emitter_scale: float = 1.0
    diffuse_model: str = "lambert"
    min_weight_sum: float = 0.5  # bake validity: the ray must hit
    checkpoint_freq: int = 5000
    plot_freq: int = 1000
    downsample_train: int = 1

    @classmethod
    def from_cfgnode(cls, node) -> "MaterialTrainConfig":
        return cls(**{f.name: node.get(f.name, f.default)
                      for f in dataclasses.fields(cls)})


# ---------------------------------------------------------------------------
# Geometry bake
# ---------------------------------------------------------------------------


@torch.no_grad()
def bake_image_geometry(render_image, uv, K, pose,
                        min_weight_sum: float = 0.5) -> dict:
    """One image's per-pixel surface geometry from the frozen model's eval
    render (`render_image(uv, K, pose)`, tensors on its device): points,
    normals, view_dirs (HW, 3) and valid (HW,) bool, tensors."""
    out = render_image(uv, K, pose)
    ray_dirs, cam_loc = get_camera_params(uv[None], pose[None], K[None])
    norms = torch.linalg.norm(ray_dirs[0], dim=-1, keepdim=True)
    units = ray_dirs[0] / torch.clamp(norms, min=1e-12)
    # z-depth times the ray's norm: the distance along the unit ray
    dist = out["depth_values"].reshape(-1) * norms[:, 0]
    points = cam_loc[0][None, :] + dist[:, None] * units
    normals = out["normal_map"].reshape(-1, 3)
    wsum = out["weight_sum"].reshape(-1)
    valid = (torch.isfinite(dist) & (dist > 1e-3) & (wsum > min_weight_sum)
             & (torch.linalg.norm(normals, dim=-1) > 0.5))
    return {"points": points, "normals": normals, "view_dirs": -units,
            "valid": valid}


def project_to_surface(net: mlp.ImplicitNet, points,
                       chunk: int = 8192) -> torch.Tensor:
    """Two Newton steps onto the SDF's zero level set, p <- p - sdf(p) g /
    |g|^2 (g the clamped SDF's spatial gradient, |g|^2 at least 1e-6), in
    zero-padded chunks of `chunk` points."""
    points = torch.as_tensor(points, dtype=torch.float32)
    n = points.shape[0]
    pad_to = chunk * max(1, math.ceil(n / chunk))
    p = torch.cat([points, points.new_zeros((pad_to - n, 3))])
    out = []
    for c in p.split(chunk):
        for _ in range(2):
            s, _, g = mlp.sdf_outputs(net, c)
            denom = torch.clamp((g * g).sum(-1), min=1e-6)
            c = c - (s[:, 0] / denom)[:, None] * g
        out.append(c)
    return torch.cat(out)[:n]


def bake_geometry(render_image, data: MaterialData, device,
                  min_weight_sum: float = 0.5):
    """Bake every training image. Returns the flat valid samples (points,
    normals, view_dirs, rgb: f32 tensors on `device`) and each image's
    full buffers (numpy) for the validation maps."""
    per_image = []
    flat = {k: [] for k in ("points", "normals", "view_dirs", "rgb")}
    uv = torch.from_numpy(data.uv).to(device)
    for i in range(data.n_images):
        g = bake_image_geometry(
            render_image, uv,
            torch.from_numpy(data.intrinsics_all[i]).to(device),
            torch.from_numpy(data.pose_all[i]).to(device),
            min_weight_sum=min_weight_sum)
        g = {k: v.cpu().numpy() for k, v in g.items()}
        per_image.append(g)
        sel = g["valid"]
        for k in ("points", "normals", "view_dirs"):
            flat[k].append(g[k][sel])
        flat["rgb"].append(np.asarray(data.rgb_images[i])[sel])
        print(f"[material] baked view {i}: {int(sel.sum())}/{sel.size} "
              "valid pixels")
    train = {k: torch.from_numpy(np.concatenate(v).astype(np.float32)
                                 ).to(device) for k, v in flat.items()}
    if train["points"].shape[0] == 0:
        raise ValueError("geometry bake produced no valid surface pixels "
                         "(is the reconstruction checkpoint trained?)")
    return train, per_image


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def make_material_train_step(tcfg: MaterialTrainConfig, sdf_fn, centers,
                             radii):
    """(step, predict, calibrate, loss_fn) over the baked buffers.
    `sdf_fn(pts) -> (N,)` is the frozen scene SDF of the visibility march
    (the trainer's K1 or plain net; tests pass analytic ones); `centers`
    (E, 3) and `radii` (E,) tensors on the buffers' device. The functions
    take the `MaterialStage` and a `Draws`; `step` takes the `TrainState`
    and returns the step's metrics."""
    layer = RenderingLayerConfig(spp=tcfg.spp,
                                 diffuse_model=tcfg.diffuse_model)
    half = RenderingLayerConfig(spp=max(tcfg.spp // 2, 1),
                                diffuse_model=tcfg.diffuse_model)
    # emitters found on a surface must not shadow their own light
    vis_sdf = carve_emitters_sdf(sdf_fn, centers, radii)

    def visibility(pts, dirs, t_max):
        return sphere_trace_visibility(vis_sdf, pts, dirs, t_max,
                                       n_steps=tcfg.vis_steps)

    def predict_with(lcfg, stage, draws, pts, normals, view_dirs,
                     e_ind=None):
        mats = stage.material(pts)
        out = shade_emitters(lcfg, draws, pts, normals, view_dirs,
                             mats["kd"], mats["ks"], mats["rough"], centers,
                             radii, emission_apply(stage.emission),
                             visibility_fn=visibility)
        # indirect light: the baked bounce where given, plus the learned
        # ambient residual
        irr = ambient_apply(stage.emission)[None]
        if e_ind is not None:
            irr = irr + e_ind
        return (out["color_diffuse"] + out["color_specular"]
                + mats["kd"] * irr, mats)

    def predict(stage, draws, pts, normals, view_dirs, e_ind=None):
        return predict_with(layer, stage, draws, pts, normals, view_dirs,
                            e_ind)

    def loss_fn(stage, draws, pts, normals, view_dirs, gt, e_ind=None):
        k_a, k_b, k_jit = draws.split(3)
        # the dual-buffer MSE: two independent half-spp buffers, each
        # residual detached and multiplied by the other's prediction, an
        # unbiased gradient of the true-mean MSE
        pred_a, mats = predict_with(half, stage, k_a, pts, normals,
                                    view_dirs, e_ind)
        pred_b, _ = predict_with(half, stage, k_b, pts, normals, view_dirs,
                                 e_ind)
        res_a = pred_a.detach() - gt
        res_b = pred_b.detach() - gt
        if tcfg.relative_mse:
            lum = gt.mean(-1, keepdim=True) + tcfg.relative_mse_eps
            if tcfg.relative_mse_pow == 2.0:
                w = 1.0 / torch.square(lum)
            else:
                w = torch.clamp(lum, min=1e-6) ** (-tcfg.relative_mse_pow)
        else:
            w = 1.0
        rgb_loss = (w * (res_a * pred_b + res_b * pred_a)).mean()
        jit_pts = pts + tcfg.smooth_eps * k_jit.normal(pts.shape).to(
            pts.device)
        mats_j = stage.material(jit_pts)
        smooth = ((mats["kd"] - mats_j["kd"]).abs().mean()
                  + (mats["rough"] - mats_j["rough"]).abs().mean())
        ks_smooth = (mats["ks"] - mats_j["ks"]).abs().mean()
        ks_reg = (mats["ks"] - tcfg.ks_prior).abs().mean()
        amb_reg = ambient_apply(stage.emission).mean()
        loss = (rgb_loss + tcfg.smooth_weight * smooth
                + tcfg.smooth_ks_weight * ks_smooth
                + tcfg.ks_prior_weight * ks_reg
                + tcfg.ambient_prior_weight * amb_reg)
        with torch.no_grad():
            mse = torch.square(0.5 * (pred_a + pred_b) - gt).mean()
            metrics = {"loss": loss.detach(), "rgb_loss": mse,
                       "smooth_loss": smooth.detach(),
                       "psnr": -10.0 * torch.log10(mse)}
        return loss, metrics

    @torch.no_grad()
    def calibrate(stage, buffers, draws, probe: int = 2048) -> None:
        """Rescale the emission in place by a probe render:
        log_radiance += log(<gt - kd e_ind> / <pred>), per channel; the
        ambient too, unless a bounce was baked (there it is a small
        residual on top of it)."""
        n = buffers["points"].shape[0]
        idx = draws.integers((min(probe, n),), n).to(
            buffers["points"].device)
        batch = {k: v[idx] for k, v in buffers.items()}
        pred, mats = predict(stage, draws.fold_in(1), batch["points"],
                             batch["normals"], batch["view_dirs"])
        gt_mean = batch["rgb"].mean(0)
        if "e_ind" in batch:
            gt_mean = gt_mean - (mats["kd"] * batch["e_ind"]).mean(0)
        scale = (torch.clamp(gt_mean, min=1e-6)
                 / torch.clamp(pred.mean(0), min=1e-6))
        log_s = torch.log(scale)
        print(f"[material] emission calibrated by x"
              f"{np.round(scale.cpu().numpy(), 3).tolist()}")
        for k, v in stage.emission.items():
            if not (k == "log_ambient" and "e_ind" in buffers):
                v.add_(log_s[None] if v.ndim == 2 else log_s)

    def step(state, buffers, draws) -> dict:
        k_idx, k_loss = draws.split(2)
        n = buffers["points"].shape[0]
        idx = k_idx.integers((tcfg.batch_size,), n).to(
            buffers["points"].device)
        batch = {k: v[idx] for k, v in buffers.items()}
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, k_loss, batch["points"],
                                batch["normals"], batch["view_dirs"],
                                batch["rgb"], batch.get("e_ind"))
        loss.backward()
        state.apply_gradients()
        return metrics

    return step, predict, calibrate, loss_fn


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def _stage_configs(conf):
    node = conf.get("material", {}) or {}
    return (MaterialTrainConfig.from_cfgnode(node),
            MaterialNetConfig.from_cfgnode(
                node.get("material_network", {}) or {}))


def load_material_stage(exp_dir: str, conf, device="cpu"):
    """A trained material stage for relight and mesh `--use_material`:
    (the `MaterialStage`, its `MaterialNetConfig`, the `Emitters` it was
    trained with, carrying the learned emission), from
    `<exp_dir>/material/` (its newest checkpoint)."""
    _, mat_cfg = _stage_configs(conf)
    em_path = os.path.join(exp_dir, "material", "emitters.npz")
    if not os.path.exists(em_path):
        raise FileNotFoundError(f"no trained material stage under {exp_dir} "
                                "(run --material first)")
    em = np.load(em_path)
    stage = MaterialStage(mat_cfg, em["init_radiance"])
    ckpt = CheckpointManager(os.path.join(exp_dir, "material",
                                          "checkpoints"))
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no material checkpoint under "
                                f"{ckpt.ckpt_dir} (run --material first)")
    payload = torch.load(ckpt.path(step), map_location="cpu",
                         weights_only=True)
    stage.load_state_dict(payload["model"])
    stage = stage.to(device).requires_grad_(False)
    emitters = Emitters(em["centers"], em["radii"],
                        emission_apply(stage.emission), device)
    print(f"[material] restored material stage @{payload['step']}; "
          f"learned emission = "
          f"{np.round(emitters.radiance.cpu().numpy(), 4).tolist()}")
    return stage, mat_cfg, emitters


class MaterialTrainer:
    """The material stage on a reconstruction model (`I2SDFModel`, on the
    device it runs on): emitter discovery, the geometry bake, the steps,
    the validation maps and the checkpoints under `<exp_dir>/material/`.
    `draws` replaces the trainer's own draws (the tests hand in JAX's)."""

    def __init__(self, conf, exp_dir: str, model, data_root: str = "data",
                 fused: bool = True, seed: int = 0,
                 draws: Draws | None = None):
        self.conf = conf
        self.exp_dir = exp_dir
        self.model = model
        self.seed = seed
        self.device = device = next(model.parameters()).device
        self.tcfg, self.mat_cfg = _stage_configs(conf)
        tcfg = self.tcfg
        self.draws = draws or Draws.seeded(seed, device)
        self.seconds = {}

        dataset_conf = dict(conf.dataset)
        scan_id = dataset_conf.pop("scan_id", 0)
        data_dir = dataset_conf["data_dir"]
        # HDR inputs where the scene has them (emission in linear units)
        is_hdr = os.path.isdir(os.path.join(data_root, data_dir,
                                            f"scan{scan_id}", "hdr"))
        self.data = MaterialData(data_dir, scan_id=scan_id,
                                 data_root=data_root, is_hdr=is_hdr,
                                 downsample_train=tcfg.downsample_train)

        t0 = time.perf_counter()
        rd = ReconData(data_dir, scan_id=scan_id, data_root=data_root,
                       use_depth=True, use_lightmask=True)
        self.emitters = find_emitters(
            rd, n_emitters=tcfg.n_emitters, emitter_scale=tcfg.emitter_scale,
            draws=self.draws, device=device)
        self.seconds["emitters"] = time.perf_counter() - t0
        print(f"[material] {self.emitters.count} emitters at "
              f"{np.round(self.emitters.centers.cpu().numpy(), 3).tolist()}")

        t0 = time.perf_counter()
        render_image = make_eval_render_fn(
            model, chunk_size=conf.train.get("split_n_pixels", 12000),
            fused=fused)
        self.buffers, self.per_image = bake_geometry(
            render_image, self.data, device,
            min_weight_sum=tcfg.min_weight_sum)
        self._sync()
        self.seconds["bake"] = time.perf_counter() - t0
        self.n_baked = int(self.buffers["points"].shape[0])
        print(f"[material] baked {self.n_baked} surface samples")

        t0 = time.perf_counter()
        if tcfg.project_surface:
            # each image's valid points once; the flat buffer is their
            # concatenation in bake order
            flat = []
            for g in self.per_image:
                sel = g["valid"]
                proj = project_to_surface(
                    model.implicit, torch.from_numpy(g["points"][sel]).to(
                        device)).cpu().numpy()
                g["points"] = np.array(g["points"])
                g["points"][sel] = proj
                flat.append(proj)
            self.buffers["points"] = torch.from_numpy(
                np.concatenate(flat).astype(np.float32)).to(device)
        self._sync()
        self.seconds["project"] = time.perf_counter() - t0

        # emitting surfaces show emission, not reflected light: drop the
        # samples inside an emitter ball (plus the carve's margin)
        centers = self.emitters.centers.cpu().numpy()
        radii = self.emitters.radii.cpu().numpy()

        def outside(pts):
            keep = np.ones(pts.shape[0], bool)
            for e in range(self.emitters.count):
                keep &= (np.linalg.norm(pts - centers[e], axis=-1)
                         > float(radii[e]) + EMITTER_MARGIN)
            return keep

        keep = outside(self.buffers["points"].cpu().numpy())
        self.n_excluded = int((~keep).sum())
        if not keep.all():
            k = torch.from_numpy(keep).to(device)
            self.buffers = {n: v[k] for n, v in self.buffers.items()}
            print(f"[material] excluded {self.n_excluded} emitter-surface "
                  "samples from the fit")
        for g in self.per_image:
            g["valid"] = g["valid"] & outside(g["points"])

        if tcfg.indirect_spp > 0:
            self._bake_indirect()

        self.draws, _ = self.draws.split(2)   # the JAX init's key
        stage = MaterialStage(self.mat_cfg, self.emitters.radiance.cpu(),
                              seed=seed).to(device)

        # the frozen SDF of the visibility march: K1 on the card
        self.fused = fused and device.type == "cuda"
        if self.fused:
            pack = sdf_mlp.SdfMlpPack(model.implicit)

            def sdf_fn(pts):
                return sdf_mlp.sdf_mlp_nograd(pack, pts)
        else:
            def sdf_fn(pts):
                return mlp.sdf_vals(model.implicit, pts)[:, 0]

        self.step_fn, self.predict_fn, calibrate, _ = \
            make_material_train_step(tcfg, sdf_fn, self.emitters.centers,
                                     self.emitters.radii)
        if tcfg.calibrate_emission:
            self.draws, k_cal = self.draws.split(2)
            calibrate(stage, self.buffers, k_cal)
        self.state = create_train_state(stage, tcfg.learning_rate,
                                        tcfg.decay_rate,
                                        decay_steps=tcfg.steps)
        mat_dir = os.path.join(exp_dir, "material")
        self.ckpt = CheckpointManager(os.path.join(mat_dir, "checkpoints"))
        self.plot_dir = os.path.join(mat_dir, "plots")
        os.makedirs(self.plot_dir, exist_ok=True)
        # relight --use_material shades with the emitters trained against
        np.savez(os.path.join(mat_dir, "emitters.npz"), centers=centers,
                 radii=radii,
                 init_radiance=self.emitters.radiance.cpu().numpy())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bake_indirect(self) -> None:
        """The one-bounce field irradiance at every training sample (and,
        smoothed, at each image's valid pixels), baked once."""
        from ..models.indirect import (bake_indirect_irradiance,
                                       make_field_radiance_fn,
                                       smooth_irradiance)

        tcfg, em = self.tcfg, self.emitters
        field_fn = make_field_radiance_fn(self.model,
                                          n_steps=tcfg.indirect_steps)
        self.draws, k_ind = self.draws.split(2)
        t0 = time.perf_counter()
        pts = self.buffers["points"].cpu().numpy()
        nrm = self.buffers["normals"].cpu().numpy()
        e_raw = bake_indirect_irradiance(
            field_fn, k_ind, pts, nrm, spp=tcfg.indirect_spp,
            emitter_centers=em.centers, emitter_radii=em.radii,
            chunk=tcfg.indirect_chunk, device=self.device)
        sk = tcfg.indirect_smooth_k
        e_ind = (smooth_irradiance(pts, nrm, e_raw, k=sk, device=self.device)
                 if sk > 0 else e_raw)
        self.buffers["e_ind"] = torch.from_numpy(e_ind).to(self.device)
        for i, g in enumerate(self.per_image):
            sel = g["valid"]
            e_full = np.zeros_like(g["points"], dtype=np.float32)
            if sel.any():
                if sk > 0:
                    # the smoothed cache read at the validation pixels
                    e_full[sel] = smooth_irradiance(
                        pts, nrm, e_ind, k=sk,
                        query_points=g["points"][sel],
                        query_normals=g["normals"][sel], device=self.device)
                else:
                    e_full[sel] = bake_indirect_irradiance(
                        field_fn, k_ind.fold_in(1000 + i), g["points"][sel],
                        g["normals"][sel], spp=tcfg.indirect_spp,
                        emitter_centers=em.centers, emitter_radii=em.radii,
                        chunk=tcfg.indirect_chunk, device=self.device)
            g["e_ind"] = e_full
        self.seconds["indirect"] = time.perf_counter() - t0
        print(f"[material] baked one-bounce indirect irradiance "
              f"({tcfg.indirect_spp} spp) in {self.seconds['indirect']:.1f}s;"
              f" mean = {np.round(e_ind.mean(0), 4).tolist()}")

    # -- validation artifacts ----------------------------------------------

    @torch.no_grad()
    def render_material_maps(self, view: int = 0, chunk: int = 8192) -> dict:
        """Full-image kd, roughness and re-rendered maps of one view, in
        zero-padded chunks of `chunk` points, each on a child of the
        trainer's draws."""
        g = self.per_image[view]
        H, W = self.data.img_res
        n = g["points"].shape[0]
        kd = np.zeros((n, 3), np.float32)
        rough = np.zeros((n,), np.float32)
        render = np.zeros((n, 3), np.float32)
        stage = self.state.model
        for s in range(0, n, chunk):
            e = min(s + chunk, n)

            def padded(a):
                a = torch.from_numpy(np.asarray(a[s:e], np.float32))
                return torch.cat([a, a.new_zeros((chunk - (e - s),)
                                                  + a.shape[1:])]).to(
                    self.device)

            self.draws, k = self.draws.split(2)
            pred, mats = self.predict_fn(
                stage, k, padded(g["points"]), padded(g["normals"]),
                padded(g["view_dirs"]),
                padded(g["e_ind"]) if "e_ind" in g else None)
            render[s:e] = pred[: e - s].cpu().numpy()
            kd[s:e] = mats["kd"][: e - s].cpu().numpy()
            rough[s:e] = mats["rough"][: e - s].cpu().numpy()
        valid = g["valid"][:, None]
        return {"kd": (kd * valid).reshape(H, W, 3),
                "rough": (rough * valid[:, 0]).reshape(H, W),
                "render": (render * valid).reshape(H, W, 3),
                "gt": np.asarray(self.data.rgb_images[view]).reshape(H, W, 3),
                "valid": np.asarray(g["valid"]).reshape(H, W)}

    def _write_plots(self, step: int, view: int = 0) -> float:
        maps = self.render_material_maps(view)
        tag = f"{step:06d}_{view}"
        imaging.write_png(os.path.join(self.plot_dir, f"kd_{tag}.png"),
                          imaging.to_u8(maps["kd"]))
        artifacts.write_colormap(
            os.path.join(self.plot_dir, f"rough_{tag}.png"), maps["rough"])
        pred, gt = maps["render"], maps["gt"]
        if self.data.is_hdr:
            pred, gt = imaging.linear_to_srgb(pred), imaging.linear_to_srgb(gt)
        imaging.write_png(os.path.join(self.plot_dir, f"render_{tag}.png"),
                          imaging.to_u8(np.concatenate([pred, gt], 1)))
        m = maps["valid"]
        mse = float(np.mean((maps["render"] - maps["gt"])[m] ** 2))
        val_psnr = -10.0 * np.log10(max(mse, 1e-12))
        print(f"[material {step}] view {view} re-render PSNR {val_psnr:.2f}")
        return val_psnr

    # -- loop ----------------------------------------------------------------

    def resume(self) -> int:
        """Restore the newest material checkpoint; returns its step."""
        self.ckpt.restore(self.state)
        print(f"[material] resumed from step {self.state.step}")
        return self.state.step

    def step_draws(self, step: int) -> Draws:
        """Step `step`'s draws: a function of (seed + 1, step)."""
        return Draws(step_generator(self.seed + 1, step, self.device))

    def fit(self, max_steps: int | None = None, log_freq: int = 100):
        """Run to the global step `max_steps` (else the configured total);
        returns the train state."""
        steps = max_steps if max_steps is not None else self.tcfg.steps
        t0 = time.time()
        start = self.state.step
        n_iter = max(steps - start, 0)
        for i in range(n_iter):
            metrics = self.step_fn(self.state, self.buffers,
                                   self.step_draws(start + i))
            step = self.state.step
            if step % log_freq == 0 or i == n_iter - 1:
                m = {k: float(v) for k, v in metrics.items()}
                rate = (step - start) / max(time.time() - t0, 1e-9)
                print(f"[material {step}/{steps}] loss={m['loss']:.4f} "
                      f"rgb={m['rgb_loss']:.4f} psnr={m['psnr']:.2f} "
                      f"({rate:.1f} steps/s)")
            if self.tcfg.plot_freq and step % self.tcfg.plot_freq == 0:
                self._write_plots(step)
            if (self.tcfg.checkpoint_freq
                    and step % self.tcfg.checkpoint_freq == 0):
                self.ckpt.save(self.state)
        self.ckpt.save(self.state)
        emission = emission_apply(self.state.model.emission)
        print(f"[material] done; learned emission = "
              f"{np.round(emission.detach().cpu().numpy(), 4).tolist()}")
        return self.state
