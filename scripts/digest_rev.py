"""SHA-256 digests of K5's and K6's outputs at the smoke's seeded inputs,
so that two trees' kernels can be held to the same bits.

    python scripts/digest_rev.py [TREE]

Imports the package and `chip_smoke.py` of TREE (default: this
repository; e.g. a `git archive` of another commit unpacked under
`exps/`), builds its kernels there, and prints one JSON line per point
set of `chip_smoke.check_rev` (the eikonal batch's 4,800 points and the
155,200 render points) with the digests of K5's outputs (sdf and
features, gradient) and of K6's weight gradients at the init of the
training config's SDF net (seed `SEED`). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from i2sdf_tpu_torch.ops.kernels import build, rev  # noqa: E402


def digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    assert Path(cs.__file__).resolve().parent == TREE, cs.__file__
    build.build()
    device = torch.device("cuda", 0)
    conf = cs.train_conf()
    cfg, model = cs.seeded_model(conf, device)
    lins = model.implicit.layers()
    ws, bs = [l.weight() for l in lins], [l.b for l in lins]
    with torch.no_grad():
        k = rev.RevLayout(cfg.implicit, ws, bs)
    for label, x in (("eikonal", cs.eikonal_batch(cfg, conf, device,
                                                  cs.SEED + 8)),
                     ("render", cs.render_batch(cfg, conf, device))):
        with torch.no_grad():
            out, grad = rev.rev_fwd(k, x)
        out_p, grad_p = rev.rev_plain(cfg.implicit, ws, bs, x)
        c_out, c_g = cs.rev_cotangents(out_p, grad_p, cs.SEED + 9)
        with torch.no_grad():
            dws, dbs = rev.rev_bwd(k, x, c_out, c_g)
        torch.cuda.synchronize()
        print(json.dumps({"tree": str(TREE), "points": label,
                          "n": x.shape[0], "k5": digest([out, grad]),
                          "k6": digest(dws + dbs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
