"""Time K1 and K3 at the smoke's shapes on variants of the tree, to see
what bounds them.

    python scripts/probe_k1_k3.py [VARIANT ...]

Each variant (default: all of `VARIANTS`) is a copy of the package with
one change (`plant_faults.copy_tree`); most give wrong outputs and serve
only to time what is left: `no_softplus` drops the epilogues'
Softplus(100) (h = z, s = 1), `tiny_stages` copies 128 bytes a stage
instead of the stage (the ring's barriers as before, no L2 weight
traffic), `ring4` takes four slots instead of three. Prints one JSON line
per variant: K1 at the sampler's first round (1,536,000 points) and K3 at
the first eval chunk (1,164,000 points), the mean of 10 launches after a
warm-up by CUDA events, with the card's name and power limit. Needs a
CUDA device and `nvcc`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from plant_faults import copy_tree  # noqa: E402

HDR = "i2sdf_tpu_torch/csrc/wgmma_layer.cuh"
NO_SOFTPLUS = [
    (HDR, "  const float e = __expf(-fabsf(100.f * z));\n"
          "  return fmaxf(z, 0.f) + 0.01f * __logf(1.f + e);",
     "  return z;"),
    (HDR, "  h = fmaxf(z, 0.f) + 0.01f * __logf(1.f + e);\n"
          "  s = t > 0.f ? r : e * r;",
     "  h = z;\n  s = 1.f;")]
TINY_STAGES = (HDR, "        mbar_expect_tx(&r.full[s], bytes);\n"
                    "        bulk_copy(r.slot + s * kSlotBytes, src, bytes, "
                    "&r.full[s]);",
               "        mbar_expect_tx(&r.full[s], 128u);\n"
               "        bulk_copy(r.slot + s * kSlotBytes, src, 128u, "
               "&r.full[s]);")
VARIANTS = {"base": [],
            "ring4": [(HDR, "constexpr int kRing = 3; ",
                       "constexpr int kRing = 4; ")],
            "no_softplus": NO_SOFTPLUS,
            "tiny_stages": [TINY_STAGES],
            "no_softplus_tiny_stages": NO_SOFTPLUS + [TINY_STAGES]}

TIME = """
import json, torch
import chip_smoke as cs
from i2sdf_tpu_torch.ops.kernels import build, render_core, sdf_mlp
build.build()
device = torch.device("cuda", 0)
conf = cs.eval_conf()
cfg, model = cs.seeded_model(conf, device)
pts = cs.k1_points(cfg, conf, device)
x, dd = cs.eval_chunk_points(cfg, conf, device)
k1 = sdf_mlp.SdfMlpPack(model.implicit)
k3 = render_core.RenderCorePack(model.implicit, model.rendering)
print(json.dumps({
    "k1_ms": cs.time_ms(lambda: sdf_mlp.sdf_mlp_nograd(k1, pts), 10),
    "k3_ms": cs.time_ms(lambda: render_core.render_core_fwd(k3, x, dd), 10),
    "card": cs.nvidia_smi()}))
"""


def main(argv: list[str]) -> int:
    bad = False
    with tempfile.TemporaryDirectory() as tmp:
        for name in argv or list(VARIANTS):
            tree = copy_tree(name, VARIANTS[name], Path(tmp))
            proc = subprocess.run([sys.executable, "-c", TIME], cwd=tree,
                                  capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode != 0:
                bad = True
                print(proc.stderr[-3000:], file=sys.stderr)
                continue
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"variant": name, **row}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
