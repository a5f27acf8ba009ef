"""Time a relit view on the card, stage by stage, and what its visibility
march would cost on K1.

    python scripts/time_relight.py [--spp 64] [--emitters 1 2] [--vis_steps 32]

The smoke's relight scene (`chip_smoke.relight_root`: scan1's images and
cameras, two seeded lamps, seeded depth), the light config
(`configs/synthetic_light_mask.yml`) at full width and seeded init
weights, view 0 at 240x320, through `eval/relight.py::run_relight` with
no field bounce: for each emitter count a warm-up view, then the timed
one. Prints, per count, each stage's seconds (the geometry render,
next-event shading with its visibility `nee`, `writes`; host clock,
synchronized), the SDF evaluations the visibility makes (pixels x spp x
steps x emitters) and their rate; then the time of one march step's
batch (4,096 points x spp) through the plain f32 net (what the
visibility runs) and through K1 (`sdf_mlp_nograd`, bf16 operands), by
CUDA events, with the f32 bound of the plain net's multiply-adds. One
JSON line with the card's name and power limit. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from i2sdf_tpu_torch.eval.relight import run_relight  # noqa: E402
from i2sdf_tpu_torch.models import mlp  # noqa: E402
from i2sdf_tpu_torch.ops.kernels import build, sdf_mlp  # noqa: E402

F32_PEAK = 67e12  # H100 SXM, outside the tensor cores


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--emitters", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--vis_steps", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_relight: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    build.build()
    build.load_library()
    conf = cs.light_conf(train=False)
    cfg, model = cs.seeded_model(conf, device)
    H, W = 480 // conf.dataset.downsample, 640 // conf.dataset.downsample
    out = dict(card=cs.nvidia_smi(), spp=args.spp, vis_steps=args.vis_steps,
               image=[H, W], views={})
    with tempfile.TemporaryDirectory() as tmp:
        root = cs.relight_root(tmp)
        for n in args.emitters:
            for rep in ("warm", "timed"):
                t0 = time.perf_counter()
                res = run_relight(model, conf, str(Path(tmp) / f"{n}{rep}"),
                                  data_root=root, indices=[0], spp=args.spp,
                                  n_emitters=n,
                                  emitter_scale=cs.RELIGHT_SCALE,
                                  vis_steps=args.vis_steps, indirect_spp=0,
                                  seed=cs.SEED)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            sec = res["images"][0]["seconds"]
            evals = H * W * args.spp * args.vis_steps * n
            out["views"][n] = dict(wall_s=wall, seconds=sec,
                                   setup_s=wall - sum(sec.values()),
                                   sdf_evaluations=evals,
                                   evals_per_s=evals / sec["nee"])
    pts = (torch.rand((4096 * args.spp, 3), device=device,
                      generator=torch.Generator(device).manual_seed(0))
           * 2 - 1)
    pack = sdf_mlp.SdfMlpPack(model.implicit)
    with torch.no_grad():
        plain_ms = cs.time_ms(lambda: mlp.sdf_vals(model.implicit, pts), 20)
        k1_ms = cs.time_ms(lambda: sdf_mlp.sdf_mlp_nograd(pack, pts), 20)
    macs = sum(cs.sdf_layer_macs(cfg.implicit))
    out["march_step"] = dict(
        points=pts.shape[0], plain_ms=plain_ms, k1_ms=k1_ms,
        macs_per_point=macs,
        plain_f32_bound_ms=2 * macs * pts.shape[0] / F32_PEAK * 1e3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
