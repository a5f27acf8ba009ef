"""K2 (`sampler_round`), K6 (`rev_bwd`) and K7 (`conv_check`) timed on the
card at the main path's shapes, by CUDA events and by the profiler's device
time, and the normal-off training step's device time and host split; for
one tree or several in turns.

    python scripts/time_k2_k6.py TREE [TREE ...]

Each TREE (this repository, or e.g. a `git archive` of another commit
unpacked under `exps/`) runs in a process of its own, in the order given
(parent, change, change, parent compares two trees on one card), imports
that tree's package and `chip_smoke.py`, builds its kernels there and
prints one JSON line:

* `k2`: at the eval chunk's R 12,000 rays and the training step's R 1,600,
  S = 480 (the widest round), for both of `check_kernels`' scenes (`mlp`:
  K1's SDF along the rays; `wall`) and both `final` values: `ms` (events,
  the mean of 20 launches after a warm-up, the wrapper's host work
  included) and `device_ms` (the profiler's kernel time a launch);
* `k6`: at the normal-off step's 4,800 eikonal points and at 155,200
  render points (`check_rev`'s inputs and cotangents, the training
  config's init): `ms` (events, 5 launches) and `device_ms` by kernel (the
  sweep, the products, the sums);
* `k7`: at the perray training shape (1,600 rays, S = 416): `ms` and
  `device_ms`;
* `nonormal`: the tree's own `chip_smoke.run_train(device, "nonormal")`:
  its step times, its profile's device ms a step and its `host_split`.

The first run of each tree also prints `scripts/kernel_resources.py`'s
rows for its K2, K6 and K7 sources (registers, spills, HGMMA, MUFU).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path


def profiled(fn, reps: int, keys: dict) -> dict:
    """Device ms a call of fn for each group of kernel names (a group's
    key a substring of the kernel's name), over the calls of reps that
    the trace holds (counted by the first group's kernel, launched once a
    call), and that count."""
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
        g = next((g for g, k in keys.items() if k in e.key), None)
        if g is not None:
            out[g] += dev
            # the first group's kernel runs once a call: the calls held
            calls += e.count if g == next(iter(keys)) else 0
    return {g: v / max(calls, 1) for g, v in out.items()} | {
        "calls_seen": calls}


def one(tree: Path, resources: bool) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from i2sdf_tpu_torch.models.density import effective_beta
    from i2sdf_tpu_torch.ops.kernels import (build, conv_check, rev,
                                             sampler_round, sdf_mlp)
    from i2sdf_tpu_torch.models import renderer
    assert Path(cs.__file__).resolve().parent == tree, cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    device = torch.device("cuda", 0)
    row = {"tree": str(tree), "nvidia_smi": cs.nvidia_smi()}
    if resources:
        src = tree / "i2sdf_tpu_torch" / "csrc"
        out = subprocess.run(
            [sys.executable, str(tree / "scripts" / "kernel_resources.py"),
             *(str(src / f) for f in ("sampler_round.cu", "rev_bwd.cu",
                                      "conv_check.cu"))],
            capture_output=True, text=True, check=True).stdout
        row["resources"] = [
            {k: r.get(k) for k in ("source", "name", "registers",
                                   "spill_stores", "spill_loads", "stack",
                                   "hgmma", "mufu_ops")}
            for r in map(json.loads, out.splitlines())]

    # ---- K2 and K7: check_kernels' inputs ------------------------------
    # built here as `check_kernels` builds them inline, so that a tree
    # whose smoke has no helper for them can be timed on the same inputs
    conf = cs.eval_conf()
    cfg, model = cs.seeded_model(conf, device)
    sc = cfg.sampler
    R = conf.train.split_n_pixels
    _, dirs, cam = cs.chunk_rays(conf, device, R)
    gen = torch.Generator().manual_seed(cs.SEED)
    wk = renderer.KernelWeights.pack(model)
    S = sum(sc.eval_counts)
    zs = torch.sort(torch.rand((R, S), generator=gen) * sc.far, -1).values
    zs = zs.to(device).contiguous()
    pts = (cam[:, None] + zs[..., None] * dirs[:, None]).reshape(-1, 3)
    with torch.no_grad():
        mlp_sdf = sdf_mlp.sdf_mlp_nograd(wk.sdf, pts.contiguous())
    noise = 0.1 * torch.randn((R, S), generator=gen).to(device)
    scenes = {"mlp": mlp_sdf.reshape(R, S),
              "wall": (3.0 - zs + noise).contiguous()}
    z0 = torch.linspace(0.0, sc.far, sc.eval_counts[0], device=device)
    dz = z0[1:] - z0[:-1]
    beta_init = torch.sqrt((1.0 / (4.0 * math.log(sc.eps + 1.0)))
                           * (dz ** 2).sum()).expand(R).contiguous()
    beta0 = effective_beta(model.beta.detach(), cfg.beta_min)
    k2 = []
    for scene, sdf in scenes.items():
        for final, n_out in ((False, sc.eval_counts[-1]),
                             (True, sc.N_samples)):
            u = torch.linspace(0, 1, n_out, device=device).expand(R, n_out)
            for rays in (R, cs.K4_RAYS):
                args = (sc, zs[:rays].contiguous(), sdf[:rays].contiguous(),
                        beta_init[:rays].contiguous(), beta0,
                        u[:rays].contiguous(), final)
                fn = lambda: sampler_round.sampler_round(*args)  # noqa
                k2.append(dict(
                    scene=scene, final=final, shape=[rays, S, n_out],
                    ms=cs.time_ms(fn, 20),
                    device_ms=profiled(fn, 20, {"k": "sampler_round"})["k"]))
    row["k2"] = k2
    S7 = 416
    z7, s7 = zs[:cs.K4_RAYS, :S7].contiguous(), \
        scenes["wall"][:cs.K4_RAYS, :S7].contiguous()
    fn = lambda: conv_check.conv_check(sc, z7, s7, beta0)  # noqa: E731
    row["k7"] = dict(shape=[cs.K4_RAYS, S7], ms=cs.time_ms(fn, 20),
                     device_ms=profiled(fn, 20, {"k": "conv_check"})["k"])
    del model, wk, mlp_sdf, scenes, pts
    torch.cuda.empty_cache()

    # ---- K6: check_rev's inputs ----------------------------------------
    tconf = cs.train_conf()
    tcfg, tmodel = cs.seeded_model(tconf, device)
    lins = tmodel.implicit.layers()
    ws, bs = [l.weight() for l in lins], [l.b for l in lins]
    with torch.no_grad():
        k = (rev.RevStages(tcfg.implicit, ws, bs)
             if hasattr(rev, "RevStages")
             else rev.RevLayout(tcfg.implicit, ws, bs))
    groups = {"sweep": "sweep_kernel", "products": "wgrad_kernel",
              "products_mma_sync": "atb_kernel", "sums": "sum_kernel"}
    k6 = []
    for label, x in (("eikonal", cs.eikonal_batch(tcfg, tconf, device,
                                                  cs.SEED + 8)),
                     ("render", cs.render_batch(tcfg, tconf, device))):
        out_p, grad_p = rev.rev_plain(tcfg.implicit, ws, bs, x)
        c_out, c_g = cs.rev_cotangents(out_p, grad_p, cs.SEED + 9)
        del out_p, grad_p

        def fn():
            with torch.no_grad():
                rev.rev_bwd(k, x, c_out, c_g)
        k6.append(dict(points=label, n=x.shape[0], ms=cs.time_ms(fn, 5),
                       device_ms=profiled(fn, 5, groups)))
        torch.cuda.empty_cache()
    row["k6"] = k6
    del tmodel
    torch.cuda.empty_cache()

    # ---- the normal-off step -------------------------------------------
    tr = cs.run_train(device, "nonormal")
    row["nonormal"] = {key: tr[key] for key in (
        "step_s", "median_ms", "steps45_ms", "rays_per_s", "host_split",
        "launches_per_step", "profile", "kernel_vs_plain")}
    return row


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        tree, res = argv[1].split(":", 1) if ":" in argv[1] else (argv[1],
                                                                  "0")
        print(json.dumps(one(Path(tree).resolve(), res == "1")), flush=True)
        return 0
    seen, rc = set(), 0
    for tree in argv or [str(Path(__file__).resolve().parents[1])]:
        tree = str(Path(tree).resolve())
        res = "0" if tree in seen else "1"
        seen.add(tree)
        proc = subprocess.run([sys.executable, __file__, "--one",
                               f"{tree}:{res}"], capture_output=True,
                              text=True)
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
