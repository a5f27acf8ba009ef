"""Host-side estimates behind the mesh slice's prediction (CPU only, no
card, no JAX).

    python scripts/mesh_host_estimates.py [--resolution 512] [--points 20000]

1. K1's error at the flagship init's surface: the init's SDF net
   (`configs/synthetic_quality.yml`, seed 0) at `--points` points on its
   zero set (radius 0.6 less the net's SDF along seeded directions),
   f32 against an emulation of K1's rounding (bf16 weights, encoding and
   activations, f32 sums); prints the mean and max of |difference|.
2. The host's marching over a sphere grid of radius 0.6 at
   `--resolution`^3 over the aligned grid's extent (1.4), through the
   port's `native.marching_cubes`; prints its seconds. The grid is
   filled plane by plane, so the script holds about the grid's 4 bytes a
   point.
These are CPU numbers of the machine that runs the script, not device
metrics.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from i2sdf_tpu_torch import native  # noqa: E402
from i2sdf_tpu_torch.config import load_cfg  # noqa: E402
from i2sdf_tpu_torch.models import mlp, renderer  # noqa: E402
from i2sdf_tpu_torch.ops.activations import softplus_beta  # noqa: E402

CONF = Path(__file__).resolve().parents[1] / "configs" / \
    "synthetic_quality.yml"


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def k1_emulated(net: mlp.ImplicitNet, x: torch.Tensor) -> torch.Tensor:
    """The SDF with K1's operands rounded to bf16 and f32 sums."""
    cfg, lins = net.cfg, net.layers()
    inp = bf16(cfg.embed(x))
    h = inp
    for layer, lin in enumerate(lins):
        if layer in cfg.skip_in:
            h = bf16(torch.cat([h, inp], -1) / math.sqrt(2.0))
        z = h @ bf16(lin.weight().detach()) + lin.b.detach()
        h = bf16(softplus_beta(z, 100.0)) if layer < len(lins) - 1 else z
    return h[:, 0]


def surface_error(n: int) -> tuple[float, float]:
    conf = load_cfg(str(CONF))
    model = renderer.I2SDFModel(
        renderer.I2SDFConfig.from_cfgnode(conf.model), seed=0)
    net = model.implicit
    gen = torch.Generator().manual_seed(0)
    d = torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    with torch.no_grad():
        r = 0.6 - mlp.sdf_vals(net, 0.6 * d)[:, 0]  # one Newton step
        x = d * r[:, None]
        err = (k1_emulated(net, x) - mlp.sdf_vals(net, x)[:, 0]).abs()
    return float(err.mean()), float(err.max())


def marching_seconds(resolution: int) -> tuple[float, int]:
    xs = np.linspace(-0.7, 0.7, resolution, dtype=np.float32)
    yz = xs[:, None] ** 2 + xs[None, :] ** 2
    grid = np.empty((resolution,) * 3, np.float32)
    for i, x in enumerate(xs):
        grid[i] = np.sqrt(x * x + yz) - 0.6
    native.get_lib()  # build before the clock starts
    t0 = time.perf_counter()
    _, tris = native.marching_cubes(grid, 0.0, (xs[0],) * 3,
                                    (xs[1] - xs[0],) * 3)
    return time.perf_counter() - t0, len(tris)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--points", type=int, default=20_000)
    args = p.parse_args()
    mean, worst = surface_error(args.points)
    print(f"K1 emulated vs f32 at the init's surface ({args.points} "
          f"points): mean {mean:.3g}, max {worst:.3g}")
    seconds, tris = marching_seconds(args.resolution)
    print(f"marching a {args.resolution}^3 sphere grid: {seconds:.2f} s, "
          f"{tris} triangles")


if __name__ == "__main__":
    main()
