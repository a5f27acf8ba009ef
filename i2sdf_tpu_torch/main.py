"""CLI of the port (counterpart of `i2sdf_tpu/main.py`): train and render.

    python -m i2sdf_tpu_torch.main --conf configs/synthetic_quality.yml \
        --scan_id 1 [--max_steps N] [--resume] [--seed 7] [--device cpu]
    python -m i2sdf_tpu_torch.main --conf configs/synthetic.yml --test \
        --test_mode render [--indices 0 3] [--ckpt last|N|model.pt] \
        [--seed 7] [--device cpu]

The flags are the reference's. Every shipped config whose model the port
has (the flagship's, its normal-loss-off copies, the light-mask config)
runs through both modes, and so do configs with per-ray sampler
compaction (`ray_sampler.per_ray_exit`) or the NeRF++ background
(`model.bg_network`). Without `--test` the trainer runs
(`train/trainer.py`) for `--max_steps` steps (the config's
`train.steps` if not given); `--resume` continues from the newest
checkpoint of the experiment's version directory. Of the test modes only
`render` is ported; the others are refused. The model runs on the card
unless `--device cpu` is given. Render weights come from the
experiment's checkpoints, as the JAX CLI takes them (`main.py:61,181-185`
there): `--ckpt last` (the default, or `latest`) loads the newest
`<exp_dir>/checkpoints/step_N.pt`, `--ckpt N` loads step N, and a path
ending in `.pt` loads that state_dict (e.g. written from a JAX checkpoint
with `i2sdf_tpu_torch.params.from_jax_params`, or a training checkpoint).
When none is found the CLI exits with an error; it never renders the
seeded init. The experiment's version is `--version`, else a
`version_N` in the `--conf` path, else the newest one (a new one for
training without `--resume`). `--seed` defaults to None, which means the
config's `seed:` key, or 0: an explicit `--seed` always wins.
"""

from __future__ import annotations

import argparse
import os
import re

import torch

from .config import load_cfg
from .eval.render import run_render_eval
from .models.renderer import I2SDFConfig
from .params import load_model
from .train.checkpoint import CheckpointManager
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
    p.add_argument("--indices", type=int, nargs="*", default=None)
    p.add_argument("--full_res", action="store_true")
    p.add_argument("--is_val", action="store_true")
    p.add_argument("--ckpt", default="last",
                   help="'last' or 'latest' (the experiment's newest "
                        "checkpoint), a step N, or a .pt state_dict path")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log_every", type=int, default=50)
    return p


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
    if args.test and args.test_mode != "render":
        raise SystemExit(f"--test_mode {args.test_mode} is not ported yet")
    if args.is_val:
        raise SystemExit("--is_val (held-out val/ cameras) is not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the plain "
                         "PyTorch path on the CPU")
    conf = load_cfg(args.conf)
    seed = args.seed if args.seed is not None else conf.get("seed", 0)
    exp_dir = resolve_exp_dir(
        args, conf, new_version=not args.test and not args.resume)
    os.makedirs(exp_dir, exist_ok=True)
    print(f"[INFO] experiment dir: {exp_dir}")
    print(f"[INFO] device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    if not args.test:
        trainer = ReconstructionTrainer(conf, exp_dir,
                                        data_root=args.data_root,
                                        device=device, seed=seed)
        trainer.fit(max_steps=args.max_steps, resume=args.resume,
                    log_every=args.log_every)
        return 0
    path, step = resolve_ckpt(args.ckpt, exp_dir)
    cfg = I2SDFConfig.from_cfgnode(conf.model)
    model = load_model(cfg, path, seed, device)
    print(f"[INFO] restored checkpoint @{step}" if step is not None
          else f"[INFO] weights: {path}")
    run_render_eval(model, conf, exp_dir, data_root=args.data_root,
                    indices=args.indices, full_res=args.full_res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
