"""K5's gradient error in its CPU replay, with and without layer 0's low
half of the encoding.

    python scripts/k5_precision.py [SEED ...]

At the flagship SDF net of `tests/test_torch_rev_replay.py` (`sdf_net`,
seed 0) and 4,800 eikonal points drawn as the training step draws them
(`eikonal_points(4800, SEED)`; by default seed 4800, the `gpu` test's,
and seeds 1-7), prints one JSON line a seed: the largest excess of K5's
replayed gradient (`replay.K5Replay`) over 0.08 of the f32 plain op's
(`rev.rev_plain`), which `REV_TOLS` holds under 0.05, and the entries
past it, with the encoding's low half at layer 0 (`hilo`: the kernel)
and without it (`hi`: the forward K6 recomputes). CPU only, seconds a
seed.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

from i2sdf_tpu_torch.ops.kernels import replay, rev  # noqa: E402
from test_torch_rev_replay import (FLAGSHIP, eikonal_points,  # noqa: E402
                                   flat_weights, sdf_net)


def main(argv: list[str]) -> int:
    net = sdf_net(**FLAGSHIP)
    ws, bs = flat_weights(net)
    with torch.no_grad():
        k = rev.RevStages(net.cfg, ws, bs)
    for seed in [int(a) for a in argv] or [4800, *range(1, 8)]:
        x = eikonal_points(4800, seed)
        ref = rev.rev_plain(net.cfg, ws, bs, x)[1].detach()
        row = {"seed": seed}
        for name, lo in (("hilo", True), ("hi", False)):
            with torch.no_grad():
                r = replay.K5Replay(k, rev.K5Plan(k, len(x)), x, replay.bf)
                r.pe_lo = lo
                grad = r.run()[1]
            excess = (grad - ref).abs() - 0.08 * ref.abs()
            row[name] = {"excess": float(excess.max()),
                         "past": int((excess > 0.05).sum())}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
