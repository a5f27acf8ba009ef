"""Run the smoke's material phase on the card, more than once in one
process, to see how its host-bound step time moves.

    python scripts/time_material.py [--repeat 2]

Builds the kernels (`ops/kernels/build.py`), then calls
`chip_smoke.run_material_phase` `--repeat` times (the light config's
material stage at full width on a one-lamp copy of scan1, the bake cut
to `downsample_train` 2: the bake's counts and seconds, a 20-step fit,
10 steps timed one by one, K1 alone at the march's 8,192 points, one
batch with K1 and with plain visibility, a profile of three steps, a
plot). Prints the card's name and power limit, then one JSON line a
phase as the smoke prints them. Needs the card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from i2sdf_tpu_torch.ops.kernels import build  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeat", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_material: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _, nvcc_s = build.build()
    build.load_library()
    cs.emit("build", t0, nvcc_seconds=nvcc_s)
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        cs.emit("material", t0,
                **cs.run_material_phase(torch.device("cuda", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
