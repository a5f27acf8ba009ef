"""The kernels this repository's last slices rebuilt, timed on the card at
the main path's shapes, by CUDA events and by the profiler's device time,
with the eval-perray view and the normal-off training step; for one tree
or several in turns.

    python scripts/time_kernels.py [--only PART[,PART ...]] TREE [TREE ...]

PART is one of `k2` (`sampler_round`), `k5` (`rev_fwd`), `k6`
(`rev_bwd`), `k7` (`conv_check`), `k10` (`sdf_outputs`), `k11`
(`sdf_grad_fwd`), `k12` (`sdf_grad_bwd`), `eval_perray` and `nonormal`
(default: all). Each
TREE (this repository, or e.g. a `git archive` of another commit
unpacked under `exps/`) runs in a process of its own, in the order
given (parent, change, change, parent compares two trees on one card),
imports that tree's package and `chip_smoke.py`, builds its kernels there
and prints one JSON line. The inputs come from this repository's smoke
(`inputs`), so every tree runs on the same ones:

* `k2`: at the eval chunk's R 12,000 rays and the training step's R 1,600,
  S = 480 (the widest round), for both of `chip_smoke.k2_inputs`' scenes
  (`mlp`: K1's SDF along the rays; `wall`) and both `final` values: `ms`
  (events, the mean of 20 launches after a warm-up, the wrapper's host
  work included) and `device_ms` (the profiler's kernel time a launch);
* `k5`, `k6`: at the normal-off step's 4,800 eikonal points and at
  155,200 render points (`check_rev`'s inputs and cotangents, the
  training config's init): `ms` (events, 5 launches) and `device_ms` (K5:
  its kernel; K6: by kernel, the sweep, the products, the sums); K5 on its
  own pack where the tree's K5 has one (`RevLayout`), else on K6's;
* `k7`: at the perray training shape (1,600 rays) and the eval chunk's
  (12,000), S = 416, on K2's `wall` scene: `ms` and `device_ms`;
* `k10`: at the first eval chunk's 1,164,000 points (`check_sdf_outputs`'
  inputs, the eval config's init), its launch on the tree's own pack
  (`sdf_outputs.OutputStages`, or the first design's
  `sdf_grad.SdfGradLayout`): `ms` (events, 5 launches) and `device_ms`;
* `k11`: at `check_rev`'s points, its launch on the tree's own pack (the
  op's one pack, K6's `sdf_grad.bwd_stages`, where K11 is K10's kernel at
  sphere 0; or the first design's `SdfGradLayout`): `ms` and `device_ms`
  (K10's kernel, or the first design's `tangent_fwd_kernel`);
* `k12`: at `check_rev`'s points and cotangents, its launch on the tree's
  own pack (K6's, `sdf_grad.bwd_stages`, or the first design's
  `SdfGradLayout`): `ms` and `device_ms` by kernel (the sweep, the
  products, the sums: K6's, or the first design's);
* `eval_perray`: the tree's own `chip_smoke.run_eval_perray(device)`:
  the view's `render_s`, its launches and PSNR;
* `nonormal`: the tree's own `chip_smoke.run_train(device, "nonormal")`:
  its step times, its profile's device ms a step and its `host_split`.

The first run of each tree that times a kernel also prints
`scripts/kernel_resources.py`'s rows for its K2, K5, K6, K7, K10, K11 and
K12 sources (registers, spills, HGMMA, MUFU; K11's and K12's sources
hold no kernel of their own where they are K10's and K6's).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("k2", "k5", "k6", "k7", "k10", "k11", "k12", "eval_perray",
         "nonormal")
KERNEL_PARTS = {"k2", "k5", "k6", "k7", "k10", "k11", "k12"}


def profiled(fn, reps: int, keys: dict) -> dict:
    """Device ms a call of fn for each group of kernel names (a group's
    key a substring of the kernel's name, or a tuple of them), over the
    calls of reps that the trace holds (counted by the first group's
    kernel, launched once a call), and that count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {g: 0.0 for g in keys}
    calls = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        g = next((g for g, k in keys.items()
                  if any(s in e.key for s in ((k,) if isinstance(k, str)
                                              else k))), None)
        if g is not None:
            out[g] += dev
            # the first group's kernel runs once a call: the calls held
            calls += e.count if g == next(iter(keys)) else 0
    return {g: v / max(calls, 1) for g, v in out.items()} | {
        "calls_seen": calls}


def inputs():
    """This repository's `chip_smoke.py` loaded as a module of its own
    (`chip_smoke_inputs`) on the package that `sys.path` finds first: the
    functions that make the inputs every tree is timed and digested on,
    whatever its own smoke holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_cases(inp, device):
    """K2's launches on `inp.k2_inputs` (the eval config's seeded model):
    (sampler config, depths (R 12,000, S 480), {scene: sdf}, beta0,
    [(scene, final, rays, K2's arguments)] for both scenes, both `final`
    values and R 12,000 and 1,600)."""
    import torch
    conf = inp.eval_conf()
    cfg, model = inp.seeded_model(conf, device)
    sc = cfg.sampler
    zs, scenes, beta_init, beta0 = inp.k2_inputs(model, cfg, conf, device)
    R = zs.shape[0]
    cases = []
    for scene, sdf in scenes.items():
        for final, n_out in ((False, sc.eval_counts[-1]),
                             (True, sc.N_samples)):
            u = torch.linspace(0, 1, n_out, device=device).expand(R, n_out)
            for rays in (R, inp.K4_RAYS):
                cases.append((scene, final, rays, (
                    sc, zs[:rays].contiguous(), sdf[:rays].contiguous(),
                    beta_init[:rays].contiguous(), beta0,
                    u[:rays].contiguous(), final)))
    return sc, zs, scenes, beta0, cases


def one(tree: Path, resources: bool, parts) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from i2sdf_tpu_torch.ops.kernels import (build, conv_check, rev,
                                             sampler_round, sdf_grad,
                                             sdf_outputs)
    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    inp = inputs()
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    device = torch.device("cuda", 0)
    row = {"tree": str(tree), "nvidia_smi": cs.nvidia_smi()}
    if resources:
        src = tree / "i2sdf_tpu_torch" / "csrc"
        out = subprocess.run(
            [sys.executable, str(tree / "scripts" / "kernel_resources.py"),
             *(str(src / f) for f in ("sampler_round.cu", "rev_fwd.cu",
                                      "rev_bwd.cu", "conv_check.cu",
                                      "sdf_outputs.cu", "sdf_grad_fwd.cu",
                                      "sdf_grad_bwd.cu"))],
            capture_output=True, text=True, check=True).stdout
        row["resources"] = [
            {k: r.get(k) for k in ("source", "name", "registers",
                                   "spill_stores", "spill_loads", "stack",
                                   "hgmma", "mufu_ops")}
            for r in map(json.loads, out.splitlines())]

    # ---- K2 and K7: check_kernels' inputs ------------------------------
    if {"k2", "k7"} & parts:
        sc, zs, scenes, beta0, cases = k2_cases(inp, device)
    if "k2" in parts:
        row["k2"] = []
        for scene, final, rays, args in cases:
            fn = lambda: sampler_round.sampler_round(*args)  # noqa: E731
            row["k2"].append(dict(
                scene=scene, final=final,
                shape=[rays, *args[1].shape[1:], args[5].shape[1]],
                ms=cs.time_ms(fn, 20),
                device_ms=profiled(fn, 20, {"k": "sampler_round"})["k"]))
    if "k7" in parts:
        row["k7"] = []
        for R7 in (inp.K4_RAYS, zs.shape[0]):
            z7 = zs[:R7, :416].contiguous()
            s7 = scenes["wall"][:R7, :416].contiguous()
            fn = lambda: conv_check.conv_check(  # noqa: E731
                sc, z7, s7, beta0)
            row["k7"].append(dict(
                shape=[R7, 416], ms=cs.time_ms(fn, 20),
                device_ms=profiled(fn, 20, {"k": "conv_check"})["k"]))
    if {"k2", "k7"} & parts:
        del scenes, zs, cases
        torch.cuda.empty_cache()

    # ---- K10: check_sdf_outputs' inputs --------------------------------
    if "k10" in parts:
        econf = inp.eval_conf()
        ecfg, emodel = inp.seeded_model(econf, device)
        x10, _ = inp.eval_chunk_points(ecfg, econf, device)
        lins = emodel.implicit.layers()
        with torch.no_grad():
            w10 = ([l.weight() for l in lins], [l.b for l in lins])
            own = getattr(sdf_outputs, "OutputStages", None)
            k10 = (own or sdf_grad.SdfGradLayout)(ecfg.implicit, *w10)

        def fn10():
            with torch.no_grad():
                sdf_outputs.sdf_outputs_fwd(k10, ecfg.implicit, x10)
        row["k10"] = dict(
            n=x10.shape[0], ms=cs.time_ms(fn10, 5),
            device_ms=profiled(fn10, 5, {"k": ("sdf_outputs_kernel",
                                               "tangent_fwd_kernel")})["k"])
        del emodel, x10, k10
        torch.cuda.empty_cache()

    # ---- K5, K6, K11 and K12: check_rev's inputs -----------------------
    if {"k5", "k6", "k11", "k12"} & parts:
        tconf = inp.train_conf()
        tcfg, tmodel = inp.seeded_model(tconf, device)
        lins = tmodel.implicit.layers()
        ws, bs = [l.weight() for l in lins], [l.b for l in lins]
        with torch.no_grad():
            k = rev.RevStages(tcfg.implicit, ws, bs)
            # K5's own pack where the tree's K5 has one (the mma.sync K5's)
            k5 = (rev.RevLayout(tcfg.implicit, ws, bs)
                  if hasattr(rev, "RevLayout") else k)
        groups = {"sweep": ("sweep_kernel", "tangent_bwd_kernel"),
                  "products": "wgrad_kernel",
                  "products_mma_sync": "atb_kernel", "sums": "sum_kernel"}
        # K12 on the tree's own pack: K6's, or the first design's layout
        k12 = (sdf_grad.bwd_stages(tcfg.implicit, ws, bs)
               if hasattr(sdf_grad, "bwd_stages")
               else sdf_grad.SdfGradLayout(tcfg.implicit, ws, bs))
        # K11 on the tree's own pack: the first design's layout, or the
        # op's one pack (K10's kernel on its chain)
        k11 = (sdf_grad.SdfGradLayout(tcfg.implicit, ws, bs)
               if hasattr(sdf_grad, "SdfGradLayout") else k12)
        k5_rows, k6_rows, k11_rows, k12_rows = [], [], [], []
        for label, x in (("eikonal", inp.eikonal_batch(tcfg, tconf, device,
                                                       inp.SEED + 8)),
                         ("render", inp.render_batch(tcfg, tconf, device))):
            out_p, grad_p = rev.rev_plain(tcfg.implicit, ws, bs, x)
            c_out, c_g = inp.rev_cotangents(out_p, grad_p, inp.SEED + 9)
            del out_p, grad_p

            def fn5():
                with torch.no_grad():
                    rev.rev_fwd(k5, x)

            def fn6():
                with torch.no_grad():
                    rev.rev_bwd(k, x, c_out, c_g)

            def fn11():
                with torch.no_grad():
                    sdf_grad.sdf_grad_fwd(k11, x)

            def fn12():
                with torch.no_grad():
                    sdf_grad.sdf_grad_bwd(k12, x, c_out, c_g)
            if "k5" in parts:
                k5_rows.append(dict(
                    points=label, n=x.shape[0], ms=cs.time_ms(fn5, 5),
                    device_ms=profiled(fn5, 5, {"k": "sweep_kernel"})["k"]))
            if "k6" in parts:
                k6_rows.append(dict(
                    points=label, n=x.shape[0], ms=cs.time_ms(fn6, 5),
                    device_ms=profiled(fn6, 5, groups)))
            if "k11" in parts:
                k11_rows.append(dict(
                    points=label, n=x.shape[0], ms=cs.time_ms(fn11, 5),
                    device_ms=profiled(fn11, 5, {"k": (
                        "sdf_outputs_kernel", "tangent_fwd_kernel")})["k"]))
            if "k12" in parts:
                k12_rows.append(dict(
                    points=label, n=x.shape[0], ms=cs.time_ms(fn12, 5),
                    device_ms=profiled(fn12, 5, groups)))
            torch.cuda.empty_cache()
        row |= {p: r for p, r in (("k5", k5_rows), ("k6", k6_rows),
                                  ("k11", k11_rows), ("k12", k12_rows))
                if p in parts}
        del tmodel
        torch.cuda.empty_cache()

    # ---- the eval-perray view ------------------------------------------
    if "eval_perray" in parts:
        ev = cs.run_eval_perray(device)
        row["eval_perray"] = {key: ev[key] for key in (
            "render_s", "launches", "psnr")}
        torch.cuda.empty_cache()

    # ---- the normal-off step -------------------------------------------
    if "nonormal" in parts:
        tr = cs.run_train(device, "nonormal")
        row["nonormal"] = {key: tr[key] for key in (
            "step_s", "median_ms", "steps45_ms", "rays_per_s", "host_split",
            "launches_per_step", "profile", "kernel_vs_plain")}
    return row


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        tree, res = argv[1].rsplit(":", 1)
        print(json.dumps(one(Path(tree).resolve(), res == "1",
                             set(argv[2].split(",")))), flush=True)
        return 0
    parts = PARTS
    if argv[:1] == ["--only"]:
        parts, argv = tuple(argv[1].split(",")), argv[2:]
        unknown = set(parts) - set(PARTS)
        if unknown:
            print(f"unknown parts: {sorted(unknown)}", file=sys.stderr)
            return 2
    seen, rc = set(), 0
    for tree in argv or [str(ROOT)]:
        tree = str(Path(tree).resolve())
        res = "0" if tree in seen or not set(parts) & KERNEL_PARTS else "1"
        seen.add(tree)
        proc = subprocess.run([sys.executable, __file__, "--one",
                               f"{tree}:{res}", ",".join(parts)],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout.strip().splitlines()[-1] + "\n"
                         if proc.returncode == 0 and proc.stdout.strip()
                         else "")
        sys.stdout.flush()
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
