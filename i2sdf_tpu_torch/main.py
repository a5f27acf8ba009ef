"""CLI of the port (counterpart of `i2sdf_tpu/main.py`), render mode.

    python -m i2sdf_tpu_torch.main --conf configs/synthetic.yml --test \
        --test_mode render [--indices 0 3] [--ckpt model.pt] [--seed 7] \
        [--device cpu]

The flags are the reference's; only `--test --test_mode render` is
ported so far, and other modes are refused. The model runs on the card
unless `--device cpu` is given. Weights come from `--ckpt` (a `.pt`
state_dict, e.g. written from a JAX checkpoint with
`i2sdf_tpu_torch.params.from_jax_params`) or else from the seeded init.
`--seed` defaults to None, which means the config's `seed:` key, or 0: an
explicit `--seed` always wins.
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
    p.add_argument("--ckpt", default=None, help="a .pt state_dict")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def resolve_exp_dir(args, conf) -> str:
    """`<exps_folder>/<expname>_<scan>/version_N`: the given version, else
    the newest existing one, else 0."""
    expname = args.expname or conf.train.get("expname", "run")
    scan_id = (args.scan_id if args.scan_id is not None
               else conf.dataset.get("scan_id", 0))
    conf.dataset.scan_id = scan_id
    base = os.path.join(args.exps_folder, f"{expname}_{scan_id}")
    version = args.version
    if version is None and os.path.isdir(base):
        found = [int(m.group(1)) for d in os.listdir(base)
                 if (m := re.fullmatch(r"version_(\d+)", d))]
        version = max(found) if found else None
    return os.path.join(base, f"version_{version or 0}")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not (args.test and args.test_mode == "render"):
        raise SystemExit("only --test --test_mode render is ported yet")
    if args.is_val:
        raise SystemExit("--is_val (held-out val/ cameras) is not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the plain "
                         "PyTorch path on the CPU")
    conf = load_cfg(args.conf)
    seed = args.seed if args.seed is not None else conf.get("seed", 0)
    exp_dir = resolve_exp_dir(args, conf)
    os.makedirs(exp_dir, exist_ok=True)
    print(f"[INFO] experiment dir: {exp_dir}")
    print(f"[INFO] device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    cfg = I2SDFConfig.from_cfgnode(conf.model)
    model = load_model(cfg, args.ckpt, seed, device)
    print(f"[INFO] weights: {args.ckpt or f'seeded init (seed {seed})'}")
    run_render_eval(model, conf, exp_dir, data_root=args.data_root,
                    indices=args.indices, full_res=args.full_res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
