"""SHA-256 digests of K5's, K6's, K11's, K12's, K4's, K3's, K3-light's and
K2's outputs at the smoke's seeded inputs, so that two trees' kernels can
be held to the same bits; and of K10's at sphere radius 0 beside K11's.

    python scripts/digest_rev.py [TREE]

Imports the package and `chip_smoke.py` of TREE (default: this
repository; e.g. a `git archive` of another commit unpacked under
`exps/`), builds its kernels there, and prints one JSON line per point
set of `chip_smoke.check_rev` (the eikonal batch's 4,800 points and the
155,200 render points) with the digests of K5's and K11's outputs (sdf
and features, gradient) and of K6's weight gradients at the init of the
training config's SDF net (seed `SEED`), and of K12's where the tree's
K12 is K6 (`sdf_grad.bwd_stages`: then K6's digest); K11 on the tree's
own pack (the first design's `sdf_grad.SdfGradLayout`, else the op's one
pack, `bwd_stages`), and beside it K10 (`sdf_outputs.OutputStages`) at
the same config with no bounding sphere (`k10_sphere0`: K11's digest
where K11 is K10's kernel at sphere 0, as `k11_is_k10` says), then one
line with
the digest of K4's weight gradients at `chip_smoke.check_k4`'s inputs
(the training config's init, `k4_batch`'s 160,000 points, the seeded
loss's cotangents), then one line each with the digest of K3's outputs
(sdf, gradient, rgb; and the light mask) at `chip_smoke.check_k3`'s
inputs (the first eval chunk's 1,164,000 points and directions at the
init of the flagship eval config, and of the light config for
K3-light), then one line with the digest of K2's betas and draws at
`check_kernels`' inputs (`chip_smoke.k2_inputs` of this repository's
smoke, through `time_kernels.k2_cases`: both scenes, both `final` values,
R 12,000 and 1,600). K5 runs on its own pack where the
tree's K5 has one (`RevLayout`), else on K6's (`RevStages`). Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from i2sdf_tpu_torch.ops.kernels import (build, render_core, rev,  # noqa
                                         sampler_round, sdf_grad,
                                         sdf_outputs)
from time_kernels import inputs, k2_cases  # noqa: E402


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
        k6 = rev.RevStages(cfg.implicit, ws, bs)
        k = (rev.RevLayout(cfg.implicit, ws, bs)
             if hasattr(rev, "RevLayout") else k6)
        k12 = (sdf_grad.bwd_stages(cfg.implicit, ws, bs)
               if hasattr(sdf_grad, "bwd_stages") else None)
        k11 = (sdf_grad.SdfGradLayout(cfg.implicit, ws, bs)
               if hasattr(sdf_grad, "SdfGradLayout") else k12)
        cfg0 = dataclasses.replace(cfg.implicit, sdf_bounding_sphere=0.0)
        k10 = sdf_outputs.OutputStages(cfg0, ws, bs)
    for label, x in (("eikonal", cs.eikonal_batch(cfg, conf, device,
                                                  cs.SEED + 8)),
                     ("render", cs.render_batch(cfg, conf, device))):
        with torch.no_grad():
            out, grad = rev.rev_fwd(k, x)
            out11, grad11 = sdf_grad.sdf_grad_fwd(k11, x)
            sdf10, feat10, grad10 = sdf_outputs.sdf_outputs_fwd(k10, cfg0, x)
            out10 = torch.cat([sdf10, feat10], 1)
        out_p, grad_p = rev.rev_plain(cfg.implicit, ws, bs, x)
        c_out, c_g = cs.rev_cotangents(out_p, grad_p, cs.SEED + 9)
        with torch.no_grad():
            dws, dbs = rev.rev_bwd(k6, x, c_out, c_g)
            g12 = (None if k12 is None else
                   sdf_grad.sdf_grad_bwd(k12, x, c_out, c_g))
        torch.cuda.synchronize()
        print(json.dumps({"tree": str(TREE), "points": label,
                          "n": x.shape[0], "k5": digest([out, grad]),
                          "k6": digest(dws + dbs),
                          "k11": digest([out11, grad11]),
                          "k10_sphere0": digest([out10, grad10]),
                          "k11_is_k10": bool(torch.equal(out11, out10)
                                             and torch.equal(grad11,
                                                             grad10)),
                          "k12": None if g12 is None else digest(
                              g12[0] + g12[1])}), flush=True)
    x, d, _ = cs.k4_batch(cfg, cs.eval_conf(), device)
    w = render_core.CoreWeights.of(model.implicit, model.rendering)
    outs = render_core.render_core_train_plain(cfg.implicit, cfg.rendering,
                                               w, x, d)
    cot = cs.loss_cotangents(*outs, cs.K4_EIK, cs.SEED + 5)
    del outs
    with torch.no_grad():
        packs = (render_core.CoreStages(cfg.implicit, cfg.rendering, w),
                 render_core.K4Stages(cfg.implicit, cfg.rendering, w))
        grads = render_core.render_core_bwd(*packs, x, d, cot)
    torch.cuda.synchronize()
    print(json.dumps({"tree": str(TREE), "points": "k4_batch",
                      "n": x.shape[0],
                      "k4": digest([t for g in grads for t in g])}),
          flush=True)
    del grads, packs, x, d, cot
    torch.cuda.empty_cache()
    for name, econf in (("k3", cs.eval_conf()),
                        ("k3_light", cs.light_conf(train=False))):
        ecfg, emodel = cs.seeded_model(econf, device)
        x, dd = cs.eval_chunk_points(ecfg, econf, device)
        with torch.no_grad():
            st = render_core.CoreStages(
                ecfg.implicit, ecfg.rendering, render_core.CoreWeights.of(
                    emodel.implicit, emodel.rendering, emodel.light),
                None if emodel.light is None else emodel.light.cfg)
            outs = render_core._launch_fwd(st, x, dd)
        torch.cuda.synchronize()
        print(json.dumps({"tree": str(TREE), "points": "eval_chunk",
                          "n": x.shape[0], name: digest(outs)}), flush=True)
        del emodel, st, outs, x, dd
        torch.cuda.empty_cache()
    outs = []
    for *_, args in k2_cases(inputs(), device)[-1]:
        outs += list(sampler_round.sampler_round(*args))
    torch.cuda.synchronize()
    print(json.dumps({"tree": str(TREE), "points": "k2_inputs",
                      "k2": digest(outs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
