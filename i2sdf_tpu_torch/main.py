"""CLI of the port (counterpart of `i2sdf_tpu/main.py`): train, render,
extract and score a mesh, interpolate views, relight.

    python -m i2sdf_tpu_torch.main --conf configs/synthetic_quality.yml \
        --scan_id 1 [--max_steps N] [--resume] [--val_mesh] [--seed 7] \
        [--profile START[:COUNT]] [--no_fused] [--device cpu]
    python -m i2sdf_tpu_torch.main --conf configs/synthetic.yml --test \
        --test_mode render [--indices 0 3] [--is_val] \
        [--ckpt last|N|model.pt] [--seed 7] [--no_fused] [--device cpu]
    python -m i2sdf_tpu_torch.main --conf configs/synthetic_quality.yml \
        --scan_id 1 --test --test_mode mesh [--resolution 512] [--score] \
        [--far_clip 5.0]
    python -m i2sdf_tpu_torch.main --conf configs/synthetic_quality.yml \
        --scan_id 1 --test --test_mode interpolate [--inter_id 0 1] \
        [--n_frames 60] [--frame_rate 24]
    python -m i2sdf_tpu_torch.main --conf configs/synthetic_light_mask.yml \
        --test --test_mode relight [--spp 64] [--n_emitters 1] \
        [--emitter_scale 1.0] [--indirect_spp N] [--edit_conf edits.yml]
    python -m i2sdf_tpu_torch.main --conf ... --test --test_mode \
        relight_video [--inter_id 0 1] [--n_frames 60] [--spp 64]
    python -m i2sdf_tpu_torch.main --conf configs/synthetic_light_mask.yml \
        --material [--max_steps N] [--resume]
    python -m i2sdf_tpu_torch.main --conf ... --test --test_mode \
        relight|relight_video|mesh --use_material

The flags are the reference's. Every shipped config whose model the port
has (the flagship's, its normal-loss-off copies, the light-mask config)
trains and renders, and so do configs with per-ray sampler compaction
(`ray_sampler.per_ray_exit`) or the NeRF++ background
(`model.bg_network`). Without `--test` the trainer runs
(`train/trainer.py`) for `--max_steps` steps (the config's `train.steps`
if not given); `--resume` continues from the newest checkpoint of the
experiment's version directory; `--val_mesh` extracts a mesh at each
validation (`plots/mesh/{step}.ply` and `.html`, at the config's
`plot.resolution`). The test modes `render` (`eval/render.py`), `mesh`
(`eval/mesh.py`: `eval/mesh/scan{N}.ply` and `.html` at `--resolution`,
with `--score` the refused meshes and `metrics.txt` against the scan's
`mesh.ply`) and `interpolate` (`eval/interpolate.py`: `--n_frames`
frames from view `--inter_id`'s first pose to its second, a video at
`--frame_rate` when ffmpeg is on the path), `relight` and `relight_video`
(`eval/relight.py`: `eval/relight/{i}_relit.png`, `_diffuse.png`,
`_specular.png` and `_relit.npy`, and the relit frames of `--inter_id`'s
flythrough; `--spp` next-event samples a pixel and emitter, `--n_emitters`
clusters of the GT light-mask pixels unprojected by GT depth (without
them, of the model's light head), `--emitter_scale`, `--indirect_spp`
field-bounce samples, `--edit_conf` a YAML of material override maps and
`emission_scale`, read with the port's own YAML reader) are ported.
`--material` trains the material stage (`train/material.py`) on the
experiment's reconstruction checkpoint for `--max_steps` steps (the
config's `material.steps` if not given), `--resume` continuing from its
newest checkpoint under `<exp_dir>/material/checkpoints/`; with
`--use_material` the relight modes shade with the trained stage's
materials, emitters and ambient, and the mesh mode bakes its albedo into
the PLY's vertex colours. As in the JAX CLI the relight draws and the
material trainer are seeded with `--seed` as given
(`i2sdf_tpu/main.py:192,246`).
`--is_val` renders
the held-out `val/` views (`val_mat_i @ scale_mat_0`) into `eval/test/`;
as in the JAX CLI, training takes the flag and validates on the training
views all the same (the JAX trainer's `PlotData` is handed the training
arrays). `--profile START[:COUNT]` traces COUNT training steps (5 if not
given) from step START into `<exp_dir>/profile/` (`utils/profiling.py`).
`--no_fused` is the JAX CLI's (`fused_sampler=False`): the sampler's
SDF and rounds in training, the whole eval render (sampler, forward and
background) and the mesh's grids run their plain PyTorch versions, on
the card too; the training render core and background stay on their
kernels, as in the JAX package. Nothing else turns the plain versions
on. On the card a test mode ends by printing its kernels' launch counts
(`ops/kernels::launch_counts`). The mesh and interpolation flags'
defaults are the JAX CLI's. The model runs on the card unless `--device
cpu` is given. Test weights come from the experiment's checkpoints, as
the JAX CLI takes them (`main.py:61,181-185` there): `--ckpt last` (the
default, or `latest`) loads the newest
`<exp_dir>/checkpoints/step_N.pt`, `--ckpt N` loads step N, and a path
ending in `.pt` loads that state_dict (e.g. written from a JAX
checkpoint with `i2sdf_tpu_torch.params.from_jax_params`, or a training
checkpoint). When none is found the CLI exits with an error; it never
evaluates the seeded init. The experiment's version is `--version`, else
a `version_N` in the `--conf` path, else the newest one (a new one for
training without `--resume`). The seed is the JAX CLI's
(`i2sdf_tpu/main.py:63,160`): `--seed` defaults to 42, and a config's
`seed:` key wins unless `--seed` is given another value.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import torch

from .config import load_cfg
from .config.cfgnode import parse_yaml
from .eval.interpolate import run_interpolation
from .eval.mesh import run_mesh_eval
from .eval.relight import run_relight, run_relight_video
from .eval.render import run_render_eval
from .models.renderer import I2SDFConfig
from .ops import kernels
from .params import load_model
from .train.checkpoint import CheckpointManager
from .train.material import MaterialTrainer, load_material_stage
from .train.trainer import ReconstructionTrainer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="i2sdf_tpu_torch")
    p.add_argument("--conf", required=True, help="config YAML path")
    p.add_argument("--exps_folder", default="exps")
    p.add_argument("--expname", default=None)
    p.add_argument("--scan_id", type=int, default=None)
    p.add_argument("--data_root", default="data")
    p.add_argument("--test", action="store_true")
    p.add_argument("--test_mode", default="render",
                   choices=["render", "mesh", "interpolate", "relight",
                            "relight_video"])
    p.add_argument("--version", type=int, default=None)
    p.add_argument("--inter_id", type=int, nargs=2, default=[0, 1])
    p.add_argument("--indices", type=int, nargs="*", default=None)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--frame_rate", type=int, default=24)
    p.add_argument("--full_res", action="store_true")
    p.add_argument("--is_val", action="store_true")
    p.add_argument("--val_mesh", action="store_true")
    p.add_argument("--score", action="store_true")
    p.add_argument("--far_clip", type=float, default=5.0)
    p.add_argument("--ckpt", default="last",
                   help="'last' or 'latest' (the experiment's newest "
                        "checkpoint), a step N, or a .pt state_dict path")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--spp", type=int, default=64,
                   help="relight: samples per pixel and emitter")
    p.add_argument("--edit_conf", default=None,
                   help="relight: YAML of material override maps (keys "
                        "mask/normal/rough/kd/ks -> image paths) and "
                        "`emission_scale`")
    p.add_argument("--n_emitters", type=int, default=1)
    p.add_argument("--emitter_scale", type=float, default=1.0)
    p.add_argument("--indirect_spp", type=int, default=None,
                   help="relight: one-bounce indirect samples a shading "
                        "point from the trained radiance field (default: "
                        "the config's `material.indirect_spp`, else 0)")
    p.add_argument("--material", action="store_true",
                   help="train the material stage on the experiment's "
                        "reconstruction checkpoint")
    p.add_argument("--use_material", action="store_true",
                   help="relight and mesh: use the trained material stage")
    p.add_argument("--no_fused", action="store_true",
                   help="run the sampler (training) and the eval render "
                        "through their plain PyTorch versions")
    p.add_argument("--profile", default=None, metavar="START[:COUNT]",
                   help="trace COUNT training steps (default 5) from step "
                        "START into <exp_dir>/profile/")
    return p


def resolve_seed(flag: int, conf) -> int:
    """The JAX CLI's precedence: the config's `seed:` wins unless the flag
    differs from its default, 42."""
    return flag if flag != 42 or "seed" not in conf else conf.seed


def resolve_exp_dir(args, conf, new_version: bool = False) -> str:
    """`<exps_folder>/<expname>_<scan>/version_N`: the given version, else
    a `version_N` in the `--conf` path, else the newest existing one (a
    fresh one past it with `new_version`), else 0."""
    expname = args.expname or conf.train.get("expname", "run")
    scan_id = (args.scan_id if args.scan_id is not None
               else conf.dataset.get("scan_id", 0))
    conf.dataset.scan_id = scan_id
    base = os.path.join(args.exps_folder, f"{expname}_{scan_id}")
    version = args.version
    if version is None and (m := re.search(r"version_(\d+)", args.conf)):
        version = int(m.group(1))
    if version is None and os.path.isdir(base):
        found = [int(m.group(1)) for d in os.listdir(base)
                 if (m := re.fullmatch(r"version_(\d+)", d))]
        version = max(found) if found else None
        if new_version and version is not None:
            version += 1
    return os.path.join(base, f"version_{version or 0}")


def resolve_ckpt(ckpt: str, exp_dir: str) -> tuple[str, int | None]:
    """(path, step) of the weights to render: a `.pt` path as it is (step
    None), else `last`/`latest` or a step N of `<exp_dir>/checkpoints`.
    Exits with an error when there is no such checkpoint."""
    if ckpt.endswith(".pt"):
        if not os.path.isfile(ckpt):
            raise SystemExit(f"--ckpt {ckpt}: no such file")
        return ckpt, None
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    steps = (CheckpointManager.list_steps(ckpt_dir)
             if os.path.isdir(ckpt_dir) else [])
    if ckpt in ("last", "latest"):
        if not steps:
            raise SystemExit(f"no checkpoint under {ckpt_dir}: train first, "
                             "or pass --ckpt <state_dict.pt>")
        step = steps[-1]
    else:
        try:
            step = int(ckpt)
        except ValueError:
            raise SystemExit(f"--ckpt {ckpt!r}: expected last, latest, a "
                             "step or a .pt path") from None
        if step not in steps:
            raise SystemExit(f"no checkpoint of step {step} under "
                             f"{ckpt_dir} (have {steps})")
    return os.path.join(ckpt_dir, f"step_{step}.pt"), step


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the plain "
                         "PyTorch path on the CPU")
    conf = load_cfg(args.conf)
    seed = resolve_seed(args.seed, conf)
    fused = not args.no_fused
    if not fused:
        print("[INFO] --no_fused: the sampler and the eval render run their "
              "plain PyTorch versions (kernels off: sdf_mlp_nograd, "
              "sampler_round, conv_check, render_core_fwd*, rev_fwd at "
              "eval, bg_core_fwd at eval)")
    train_recon = not args.test and not args.material
    exp_dir = resolve_exp_dir(
        args, conf, new_version=train_recon and not args.resume)
    os.makedirs(exp_dir, exist_ok=True)
    print(f"[INFO] experiment dir: {exp_dir}")
    print(f"[INFO] device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    if train_recon:
        trainer = ReconstructionTrainer(conf, exp_dir,
                                        data_root=args.data_root,
                                        device=device, seed=seed,
                                        val_mesh=args.val_mesh,
                                        fused_sampler=fused)
        trainer.fit(max_steps=args.max_steps, resume=args.resume,
                    log_every=args.log_every, profile=args.profile)
        return 0
    path, step = resolve_ckpt(args.ckpt, exp_dir)
    cfg = I2SDFConfig.from_cfgnode(conf.model)
    model = load_model(cfg, path, seed, device)
    print(f"[INFO] restored checkpoint @{step}" if step is not None
          else f"[INFO] weights: {path}")
    material = (load_material_stage(exp_dir, conf, device=device)
                if args.use_material and not args.material
                and args.test_mode in ("mesh", "relight", "relight_video")
                else None)
    if args.material:
        mt = MaterialTrainer(conf, exp_dir, model, data_root=args.data_root,
                             fused=fused, seed=args.seed)
        if args.resume:
            mt.resume()
        mt.fit(max_steps=args.max_steps)
    elif args.test_mode == "render":
        run_render_eval(model, conf, exp_dir, data_root=args.data_root,
                        indices=args.indices, full_res=args.full_res,
                        is_val=args.is_val, fused=fused)
    elif args.test_mode == "mesh":
        run_mesh_eval(model, conf, exp_dir, data_root=args.data_root,
                      resolution=args.resolution, score=args.score,
                      far_clip=args.far_clip, fused=fused,
                      material=material)
    elif args.test_mode == "interpolate":
        run_interpolation(model, conf, exp_dir, id0=args.inter_id[0],
                          id1=args.inter_id[1], n_frames=args.n_frames,
                          frame_rate=args.frame_rate,
                          data_root=args.data_root, fused=fused)
    else:
        edit_conf = None
        if args.edit_conf:
            with open(args.edit_conf) as f:
                edit_conf = parse_yaml(f.read())
        common = dict(data_root=args.data_root, spp=args.spp,
                      n_emitters=args.n_emitters,
                      emitter_scale=args.emitter_scale, edit_conf=edit_conf,
                      fused=fused, full_res=args.full_res, seed=args.seed,
                      indirect_spp=args.indirect_spp, material=material)
        if args.test_mode == "relight_video":
            run_relight_video(model, conf, exp_dir, id0=args.inter_id[0],
                              id1=args.inter_id[1], n_frames=args.n_frames,
                              frame_rate=args.frame_rate, **common)
        else:
            run_relight(model, conf, exp_dir, indices=args.indices, **common)
    if device.type == "cuda":
        print("[INFO] kernel launches: " + json.dumps(
            {k: v for k, v in kernels.launch_counts().items() if v}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
