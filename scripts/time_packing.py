"""Host time of packing the NeRF++ background pair's weights for K8 and
K9, and the SDF net's for K5 and K6, K10, and K11 and K12, on one card,
at the smoke's bg and training configs (their seeded inits).

    python scripts/time_packing.py [TREE ...]

For each TREE in the order given (default: this repository; e.g. a `git
archive` of another commit unpacked under `exps/`; a tree may come more
than once, to time trees in turns), in a process of its own: imports
TREE's package and `chip_smoke.py`, builds the bg config's nets on the
card and times on the host clock, after a warm-up, `REPS` times each:

* `train_ms`: the pack a training step makes for K8 and K9 from the
  materialized weights (`bg_core.BgStages`, with the transposed chain
  that K9's backward reads; a tree without `BgStages` packs
  `bg_core.BgLayout`);
* `eval_ms`: the pack an eval render makes (`bg_core.BgPack`);
* `rev_fwd_ms`: K5's own pack of the training config's SDF net, where
  the tree has one (`rev.RevLayout`, the mma.sync K5's; since K5 moved
  onto K6's sweeps it reads K6's pack);
* `rev_bwd_ms`: K6's pack (`rev.RevStages`, gathered through a layout
  built once for the net's shapes; absent where the tree has none), and
  `rev_bwd_stagewise_ms` the same chains packed stage by stage
  (`mma_pack.pack_stage_chain` of `render_core.core_sdf_layers` and
  `t_sdf_layers`, the bits `RevStages` must equal);
* `rev_step_ms`: the SDF packs one normal-off step makes (`RevOp`: K5's
  and K6's, or the one both read);
* `sdf_outputs_ms`: K10's pack (`sdf_outputs.OutputStages`, K3's SDF
  chain gathered through a layout built once; the first design's
  `sdf_grad.SdfGradLayout` where the tree has no `OutputStages`);
* `sdf_grad_step_ms`: the packs one call of the tangent op makes for K11
  and K12 (`SdfGradOp`: K11's `SdfGradLayout` and K12's, K6's
  `RevStages`, both in the forward; the first design's K12 built its
  transposed chain at its first launch, `SdfGradLayout.backward`).

Each pack starts with the device idle and ends when the host returns (its
device work runs behind, as in a step); `synced_ms` adds the wait for the
device. Prints one JSON line per run: medians and minima in ms. Builds
no kernel. Without a card it times the packs on the CPU (`device`).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 50


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from i2sdf_tpu_torch.ops.kernels import bg_core
    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    cuda = torch.cuda.is_available()
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    conf = cs.bg_conf(train=True)
    cfg, model = cs.seeded_model(conf, device)
    nets = (model.bg_implicit, model.bg_rendering)
    packer = getattr(bg_core, "BgStages", None) or bg_core.BgLayout
    with torch.no_grad():
        w = bg_core.BgWeights.of(*nets)

    def train_pack():
        with torch.no_grad():
            st = packer(cfg.bg_implicit, cfg.bg_rendering, w)
            if hasattr(type(st), "pack_t"):
                st.t   # noqa: B018 (packs the transposed chain)

    def eval_pack():
        bg_core.BgPack(*nets)

    from i2sdf_tpu_torch.ops.kernels import mma_pack, render_core, rev
    tcfg, tmodel = cs.seeded_model(cs.train_conf(), device)
    lins = tmodel.implicit.layers()
    with torch.no_grad():
        ws, bs = [l.weight() for l in lins], [l.b for l in lins]
    icfg = tcfg.implicit
    packs = [("train", train_pack), ("eval", eval_pack)]
    own5 = getattr(rev, "RevLayout", None)
    if own5 is not None:
        packs.append(("rev_fwd", lambda: own5(icfg, ws, bs)))
    if hasattr(rev, "RevStages"):
        import inspect
        first = ({"first": True} if "first" in inspect.signature(
            render_core.t_sdf_layers).parameters else {})

        def stagewise():
            with torch.no_grad():
                mma_pack.pack_stage_chain(render_core.core_sdf_layers(
                    icfg, [t.float() for t in ws], [t.float() for t in bs]))
                mma_pack.pack_stage_chain(render_core.t_sdf_layers(
                    icfg, [t.float() for t in ws], **first))

        def step():
            with torch.no_grad():
                if own5 is not None:
                    own5(icfg, ws, bs)
                rev.RevStages(icfg, ws, bs)
        packs += [("rev_bwd", lambda: rev.RevStages(icfg, ws, bs)),
                  ("rev_bwd_stagewise", stagewise), ("rev_step", step)]

    from i2sdf_tpu_torch.ops.kernels import sdf_grad, sdf_outputs
    own10 = getattr(sdf_outputs, "OutputStages", sdf_grad.SdfGradLayout)

    def sdf_grad_step():
        with torch.no_grad():
            k = sdf_grad.SdfGradLayout(icfg, ws, bs)
            if hasattr(sdf_grad, "bwd_stages"):
                sdf_grad.bwd_stages(icfg, ws, bs)
            else:
                k.backward()
    packs += [("sdf_outputs", lambda: own10(icfg, ws, bs)),
              ("sdf_grad_step", sdf_grad_step)]

    out = dict(tree=str(tree), device=str(device), packer=packer.__name__,
               reps=REPS)
    for name, fn in packs:
        host, synced = [], []
        for i in range(REPS + 3):
            sync()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            if i >= 3:
                host.append((t1 - t0) * 1e3)
                synced.append((t2 - t0) * 1e3)
        out[f"{name}_ms"] = statistics.median(host)
        out[f"{name}_ms_min"] = min(host)
        out[f"{name}_synced_ms"] = statistics.median(synced)
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    trees = [Path(t).resolve() for t in sys.argv[1:]] or [ROOT]
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              str(tree)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
