"""Reconstruction training loop (counterpart of `i2sdf_tpu/train/
trainer.py`).

`ReconstructionTrainer.fit` sequences the training steps
(`train/step.py`) with the bubble window's lifecycle (activation at
`min_bubble_iter`: the point-cloud pdf initialized from an eval render of
every training pixel, or uniform with `train.uniform_bubble`; closed at
`max_bubble_iter`), periodic validation renders through the eval render
with PSNR and SSIM and their plots (the light mask too, in grey, in the
light-mask config), logs every `log_every` steps, and checkpoints. The
validation views come from the training data's arrays, light masks
included (`train.flip_light` inverts them in both, as
`trainer.py:196-205` there). With per-ray sampler compaction
(`ray_sampler.per_ray_exit`) the step's capacity phase follows the
learned beta (`trainer.py:206-222,385-406,498`): at the start of `fit`
(a resumed run's too) and every `train.per_ray_check_freq` steps the
trainer picks the phase (`train/step.py::per_ray_fracs_for_beta`, or the
config's pinned `per_ray_fracs`) and, when it changed, builds that
phase's step; PyTorch has nothing to recompile. The validation renders
keep `per_ray_exit` and pick their own phase. Left out against the JAX
trainer: LPIPS, TensorBoard, multi-device data parallelism, and the
bubble hot/count maps and point-cloud HTML of `train/artifacts.py`.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from ..data.plot import PlotData
from ..data.recon import ReconData
from ..models import renderer
from ..models.density import effective_beta
from ..models.losses import TERMS, LossConfig
from ..utils import imaging
from .checkpoint import CheckpointManager
from .state import create_train_state, make_reference_lr_schedule
from .step import (BubbleState, TrainDraws, cfg_with_fracs, eval_fracs,
                   make_eval_render_fn, make_train_step, step_generator,
                   update_pdf)


class ReconstructionTrainer:
    def __init__(self, conf, exp_dir: str, data_root: str = "data",
                 device="cuda", seed: int | None = None):
        self.conf = conf
        self.exp_dir = exp_dir
        self.device = torch.device(device)
        self.plots_dir = os.path.join(exp_dir, "plots")
        for d in (exp_dir, self.plots_dir):
            os.makedirs(d, exist_ok=True)
        self.seed = seed if seed is not None else conf.get("seed", 0)

        self.loss_cfg = lc = LossConfig.from_cfgnode(conf.loss)
        use_normal = lc.normal_weight > 0 or lc.angular_weight > 0
        ds = dict(conf.dataset)
        self.scan_id = ds.pop("scan_id", 0)
        self.data_root = data_root
        print("[INFO] Loading data ...")
        self.train_data = ReconData(
            scan_id=self.scan_id, data_root=data_root,
            use_mask=lc.mask_weight > 0, use_depth=lc.depth_weight > 0,
            use_normal=use_normal, use_bubble=lc.bubble_weight > 0,
            use_lightmask=lc.light_mask_weight > 0, **ds)
        td = self.train_data
        if td.use_lightmask and conf.train.get("flip_light", False):
            td.lightmask_images = 1.0 - td.lightmask_images
        self.device_data = td.to_device(self.device)
        self.plot_data = PlotData(
            data={"intrinsics": td.intrinsics_all, "pose": td.pose_all,
                  "rgb": td.rgb_images, "img_res": td.img_res,
                  "light_mask": td.lightmask_images},
            downsample=ds.get("downsample", 1))
        self.plot_nimgs = conf.plot.get("plot_nimgs", 1)

        conf.model.use_normal = use_normal
        self.model_cfg = renderer.I2SDFConfig.from_cfgnode(conf.model)
        model = renderer.I2SDFModel(self.model_cfg,
                                    seed=self.seed).to(self.device)
        tc = conf.train
        self.max_steps = tc.get("steps", 200_000)
        schedule = None
        if tc.get("reference_lr_schedule", False):
            schedule = make_reference_lr_schedule(
                tc.learning_rate, tc.get("sched_decay_rate", 0.1),
                n_images=self.train_data.n_images,
                total_pixels=self.train_data.total_pixels,
                batch_size=tc.batch_size)
        self.state = create_train_state(
            model, learning_rate=tc.learning_rate,
            decay_rate=tc.get("sched_decay_rate", 0.1),
            decay_steps=max(self.max_steps, 1), schedule=schedule)

        self.batch_size = tc.batch_size
        self.bubble_batch_size = tc.get("bubble_batch_size", self.batch_size)
        self.bubble_draw_every = max(int(tc.get("bubble_draw_every", 1)), 1)
        self.pdf_criterion = tc.get("pdf_criterion", "DEPTH")
        self.uniform_bubble = tc.get("uniform_bubble", False)
        self.split_n_pixels = tc.get("split_n_pixels", 12000)
        self.checkpoint_freq = tc.get("checkpoint_freq", 10000)
        if "plot_freq" in tc:
            self.plot_freq = tc.plot_freq
        elif "plot_epochs" in tc:
            self.plot_freq = tc.plot_epochs * max(int(math.ceil(
                len(self.train_data) / self.batch_size)), 1)
        else:
            self.plot_freq = 500
        self._step_kwargs = dict(
            bubble_batch_size=self.bubble_batch_size,
            pdf_prune=self.train_data.pdf_prune,
            pdf_max=self.train_data.pdf_max,
            pdf_criterion=self.pdf_criterion,
            angular_reference_bug=lc.angular_reference_bug,
            bubble_draw_every=self.bubble_draw_every)
        # per-ray compaction: the step starts on the global early exit;
        # `update_per_ray_phase` swaps in the beta's phase
        self.per_ray = self.model_cfg.sampler.per_ray_exit
        self.per_ray_check_freq = tc.get("per_ray_check_freq", 250)
        self.per_ray_fracs = None
        self.step_fn = make_train_step(
            cfg_with_fracs(self.model_cfg, None), self.batch_size,
            **self._step_kwargs)
        self.bubble: BubbleState | None = None
        self.bubble_activated = False
        self.ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        with open(os.path.join(exp_dir, "config.json"), "w") as f:
            json.dump(conf, f, indent=1)
        print(f"[INFO] Finish loading data. Data-set size: "
              f"{self.train_data.n_images}")

    # -- bubble window -------------------------------------------------------

    def initialize_bubble_pdf(self) -> None:
        """Render every training pixel and scatter |pred - gt| (depth, or
        rgb with pdf_criterion RGB) into the point-cloud pdf
        (`trainer.py:309-350`)."""
        ds, data = self.train_data, self.device_data
        pdf = torch.zeros(len(ds.pointcloud), device=self.device)
        render = make_eval_render_fn(self.state.model, self.split_n_pixels)
        hw = ds.total_pixels
        for i in range(ds.n_images):
            out = render(data.uv, data.intrinsics[i], data.pose[i])
            if self.pdf_criterion == "RGB":
                err = (out["rgb_values"].clamp(0, 1)
                       - data.rgb[i].clamp(0, 1)).abs().mean(-1)
            else:
                err = (out["depth_values"] - data.depth[i]).abs()
            idx = torch.arange(i * hw, (i + 1) * hw, device=self.device)
            pdf = update_pdf(pdf, data.pointlinks, idx, err, ds.pdf_prune,
                             ds.pdf_max)
        self.bubble = BubbleState(pdf=pdf, sample_count=torch.zeros(
            len(ds.pointcloud), dtype=torch.int64, device=self.device))
        np.save(os.path.join(self.exp_dir, "checkpoints", "pdf.npy"),
                pdf.cpu().numpy())
        print(f"[INFO] {int((pdf > 0).sum())}/{len(pdf)} points to be "
              "sampled")

    def _maybe_toggle_bubble(self, step: int) -> None:
        want = self.train_data.use_bubble and self.loss_cfg.in_bubble(step)
        if want and not self.bubble_activated:
            self.bubble_activated = True
            if self.bubble is not None:
                print("[INFO] Bubble pdf restored from checkpoint")
            elif self.uniform_bubble:
                n = len(self.train_data.pointcloud)
                print("[INFO] Ablation: uniform bubble sampling")
                self.bubble = BubbleState(
                    pdf=torch.ones(n, device=self.device),
                    sample_count=torch.zeros(n, dtype=torch.int64,
                                             device=self.device))
            else:
                print(f"[INFO] Initializing pointcloud PDF "
                      f"({self.pdf_criterion})")
                t0 = time.perf_counter()
                self.initialize_bubble_pdf()
                print(f"[INFO] pdf init took {time.perf_counter() - t0:.1f}s")
            # the draw queue is not checkpointed: redrawn on activation
            self.bubble.queue, self.bubble.queue_pos = None, 0
        elif self.bubble_activated and not want:
            self.bubble_activated = False
            self.bubble = None
            print("[INFO] Bubble window closed")

    # -- training loop -------------------------------------------------------

    def update_per_ray_phase(self) -> None:
        """Pick the per-ray capacity phase for the learned beta (the
        config's pinned `per_ray_fracs` at every beta; `eval_fracs`) and
        build its step when it changed (`trainer.py:388-406`)."""
        fracs = eval_fracs(self.state.model)
        if fracs == self.per_ray_fracs:
            return
        self.per_ray_fracs = fracs
        self.step_fn = make_train_step(
            cfg_with_fracs(self.model_cfg, fracs), self.batch_size,
            **self._step_kwargs)
        beta = float(effective_beta(self.state.model.beta.detach(),
                                    self.model_cfg.beta_min))
        print(f"[INFO] per-ray sampler phase: beta={beta:.2e} "
              f"fracs={fracs}")

    def draws(self, step: int) -> TrainDraws:
        """Step `step`'s random numbers: a function of (seed, step)."""
        gen = step_generator(self.seed + 1, step, self.device)
        n_bubble = (self.bubble_draw_every * self.bubble_batch_size
                    if self.bubble is not None else 0)
        return TrainDraws.sample(self.model_cfg, self.device_data,
                                 self.batch_size, gen, bubble_draws=n_bubble)

    def fit(self, max_steps: int | None = None, resume: bool = False,
            log_every: int = 50) -> None:
        max_steps = max_steps or self.max_steps
        if resume:
            try:
                bubble = self.ckpt.restore(self.state)
                if bubble is not None:
                    self.bubble = BubbleState(
                        pdf=bubble["pdf"].to(self.device),
                        sample_count=bubble["sample_count"].to(self.device))
                print(f"[INFO] Resumed from step {self.state.step}")
            except FileNotFoundError:
                print("[INFO] No checkpoint found, starting fresh")
        if self.per_ray:
            self.update_per_ray_phase()
        pending, t0 = [], time.perf_counter()
        step = self.state.step
        while step < max_steps:
            self._maybe_toggle_bubble(step)
            if self.per_ray and step % self.per_ray_check_freq == 0:
                self.update_per_ray_phase()
            metrics = self.step_fn(self.state, self.device_data,
                                   self.draws(step),
                                   self.loss_cfg.dynamic_weights(step),
                                   self.bubble)
            pending.append(metrics)
            step += 1
            if step % log_every == 0 or step == max_steps:
                self._flush_logs(step, pending, t0, max_steps)
                pending, t0 = [], time.perf_counter()
            if step % self.plot_freq == 0 or step == max_steps:
                self.validate(step)
            if step % self.checkpoint_freq == 0 or step == max_steps:
                self.save_checkpoint()
        print("[INFO] Training complete")

    def _flush_logs(self, step, pending, t0, total) -> None:
        if not pending:
            return
        names = list(pending[-1])
        vals = dict(zip(names, torch.stack(
            [pending[-1][k] for k in names]).cpu().tolist()))
        sps = len(pending) / max(time.perf_counter() - t0, 1e-9)
        terms = " ".join(f"{k[:-5]}={vals[k]:.4g}" for k in TERMS
                         if vals.get(k, 0.0) > 0)
        print(f"[scan{self.scan_id} {step}/{total}] loss={vals['loss']:.4f} "
              f"psnr={vals['psnr']:.2f} ({sps:.2f} steps/s, "
              f"{sps * self.batch_size:.0f} rays/s) {terms}")

    # -- validation ----------------------------------------------------------

    def validate(self, step: int) -> dict:
        t0 = time.perf_counter()
        pd = self.plot_data
        H, W = pd.img_res
        rng = np.random.default_rng(self.seed + step)
        views = rng.permutation(pd.n_images)[:self.plot_nimgs]
        render = make_eval_render_fn(self.state.model, self.split_n_pixels)
        psnrs, ssims = [], []
        for i in views:
            uv, K, pose, rgb_gt = pd.image_inputs(int(i))
            out = render(*(torch.from_numpy(a).to(self.device)
                           for a in (uv, K, pose)))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            pred = out["rgb_values"].reshape(H, W, 3)
            gt = rgb_gt.reshape(H, W, 3)
            psnrs.append(imaging.psnr(pred, gt))
            ssims.append(imaging.ssim(pred, gt))
            for sub in ("rendering", "depth", "normal"):
                os.makedirs(os.path.join(self.plots_dir, sub), exist_ok=True)
            imaging.write_png(
                f"{self.plots_dir}/rendering/{step}_{i}.png",
                np.concatenate([imaging.to_u8(pred), imaging.to_u8(gt)], 0))
            depth = out["depth_values"].reshape(H, W)
            imaging.write_png(f"{self.plots_dir}/depth/{step}_{i}.png",
                              imaging.to_u8(depth / max(float(depth.max()),
                                                        1e-6)))
            n_cam = out["normal_map"].reshape(H, W, 3) @ pose[:3, :3]
            imaging.write_png(f"{self.plots_dir}/normal/{step}_{i}.png",
                              imaging.to_u8((n_cam + 1.0) / 2.0))
            if "light_mask" in out:
                os.makedirs(f"{self.plots_dir}/light_mask", exist_ok=True)
                imaging.write_png(
                    f"{self.plots_dir}/light_mask/{step}_{i}.png",
                    imaging.to_u8(out["light_mask"].reshape(H, W)))
        result = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
        print(f"[val @{step}] " + " ".join(f"{k}={v:.4g}"
                                           for k, v in result.items())
              + f" ({time.perf_counter() - t0:.1f}s)")
        return result

    def save_checkpoint(self) -> str:
        bubble = None
        if self.bubble is not None:
            bubble = {"pdf": self.bubble.pdf,
                      "sample_count": self.bubble.sample_count}
        path = self.ckpt.save(self.state, bubble)
        print(f"[INFO] checkpoint @{self.state.step}")
        return path
