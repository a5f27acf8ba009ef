"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its wall time:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit;
2. build: the six CUDA kernels (`i2sdf_tpu_torch/csrc/*.cu`), one `nvcc`
   per source, all started together, and one link;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the flagship eval render (K1-K3) and training steps give it
   (K4: 160,000 points with the cotangents of a seeded loss; K5 and K6:
   the normal-off step's 4,800 eikonal points, and 155,200 points, the
   size the JAX renderer feeds the op on its other training route), with
   the stated tolerance; kernel, plain and library-yardstick times by CUDA
   events;
4. slice (the eval path): one 240x320 view of `data/synthetic_quality/
   scan1` rendered through the port's eval entry point (`eval/render.py`)
   at the full width of `configs/synthetic.yml`, seeded init weights;
   every output finite and every kernel of the path launched; then the
   first 12000-ray chunk rendered again through the plain path, held
   against the kernels' render;
5. train (the training path): `ReconstructionTrainer.fit` for 6 steps of
   `configs/synthetic_quality.yml` at full width (1600 rays a step) on
   scan1's images and cameras, with seeded synthetic depth, normals and
   bubble point cloud at scan1's shapes (the checkout holds no `depth/`
   or `normal/`), the bubble window open for steps 2-3 with a uniform pdf;
   every loss finite, K1-K4 launched, K4 once a step; a profile
   of two steps; then one batch through a kernel step and a plain step
   from the same weights and draws, loss terms and gradients held to the
   JAX package's gradient tolerance;
6. train_nonormal (the normal-loss-off training path): the same trainer,
   config and synthetic depth and bubble cloud with `normal_weight: 0`,
   which routes the render points through the plain nets and the
   eikonal points through K5/K6; every loss finite, per step K5 and K6
   once, K3 and K4 never, K1 and K2 at most five times (one a sampler
   round); a profile of two steps; one batch through a kernel step and a
   plain step;
7. cli: `python -m i2sdf_tpu_torch.main` in train mode for 3 steps on
   scan1 as the checkout holds it (images and cameras only), then
   `--resume` for one more step from the checkpoint it wrote, then
   `--test --test_mode render --indices 0` with no `--ckpt`, which must
   load that newest checkpoint (step 4) and write finite images; last the
   train CLI for 2 steps on a copy of the config with `normal_weight: 0`
   in the temporary directory, whose logs carry no normal term.

The card's `nvidia-smi` line is printed on its own after phase 1. The
run ends with the launch counts of each path, one JSON line with every
kernel's numbers (launches from the training path it serves), and last
`{"ok": true, "device": {...}}`. Any failure raises and exits nonzero;
with no CUDA device the script exits nonzero before printing a result.
All files are written to a temporary directory; no scene file under
`depth/`, `normal/`, `light_mask/` or `mesh.ply` is read.

Precision: the plain path is f32 throughout, with TF32 turned off for
matmuls and cuDNN; the kernels take bf16 operands with f32 accumulation.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.data.plot import PlotData
from i2sdf_tpu_torch.eval.render import run_render_eval
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.models.density import effective_beta
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops import kernels
from i2sdf_tpu_torch.ops.kernels import (build, render_core, rev,
                                         sampler_round, sdf_mlp)
from i2sdf_tpu_torch.train import step as train_step
from i2sdf_tpu_torch.train.state import create_train_state
from i2sdf_tpu_torch.train.trainer import ReconstructionTrainer
from i2sdf_tpu_torch.utils.cameras import get_camera_params

ROOT = Path(__file__).resolve().parent
CONF = ROOT / "configs" / "synthetic.yml"
TRAIN_CONF = ROOT / "configs" / "synthetic_quality.yml"
SEED = 0
EVAL_KERNELS = ("sdf_mlp_nograd", "sampler_round", "render_core_fwd")
TRAIN_KERNELS = EVAL_KERNELS + ("render_core_bwd",)
NONORMAL_KERNELS = ("sdf_mlp_nograd", "sampler_round", "rev_fwd", "rev_bwd")
TRAIN_STEPS = 6          # bubble window [2, 4): off, off, on, on, off, off
K4_RAYS, K4_EIK = 1600, 4800   # one training step's render-core batch
# K5 against its plain version: the JAX package's tolerances for its rev
# kernel (tests/test_pallas_rev.py), (atol, rtol)
REV_TOLS = {"sdf": (0.02, 0.02), "feat": (0.05, 0.05), "grad": (0.05, 0.08)}
# K4 and the training step against their plain versions: the JAX
# package's gradient tolerance for its bf16 kernel
# (tests/test_pallas_train.py:96-111), per leaf max|d| / max|ref| and the
# cosine over all leaves; loss terms to the same relative bound.
GRAD_LEAF_TOL, GRAD_COS_TOL = 0.1, 0.999
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per sample in one error-bound evaluation of the sampler
# round (Laplace density, d* term, two scans, bound, max), counted from
# csrc/sampler_round.cu; a round does beta_iters + 1 evaluations plus the
# weights / pdf / CDF pass, counted as one more.
SAMPLER_OPS_PER_SAMPLE_EVAL = 22
# Sampler round, kernel vs plain: the JAX package's own tolerance for its
# kernel against round_update (tests/test_pallas_sampler.py). The inverse
# CDF jumps where a bin's mass is under the 1e-5 guard, so f32 rounding in
# the CDF (summed in another order) can move a draw across a section.
SAMPLES_P99, SAMPLES_MAX, SAMPLES_RAY_MEAN = 0.08, 0.5, 0.02
# Rendered rgb of the kernels vs the plain path on the first chunk: bf16
# operands keep ~3 significant digits, so the rendered colour may differ
# by ~1e-2 where a surface moves by a bf16 step; 30 dB is an rms error of
# 0.03.
SLICE_PSNR_BAR_DB = 30.0


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0,
                      **fields}), flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def close(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float) -> bool:
    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def hidden_macs(icfg) -> int:
    """Multiply-adds per point of the SDF net's hidden layers (the layer
    before a skip is narrowed by the encoding's width)."""
    return sum(sdf_layer_macs(icfg)[:-1])


def sdf_layer_macs(icfg) -> list:
    """Multiply-adds per point of each SDF layer at its real width."""
    d = icfg.layer_dims()
    return [d[l] * (d[l + 1] - (d[0] if l + 1 in icfg.skip_in else 0))
            for l in range(len(d) - 1)]


# ---- library yardsticks: the same functions as bf16 torch.matmul chains ----

def _bf16_weights(net):
    return ([lin.weight().detach().to(torch.bfloat16) for lin in net.layers()],
            [lin.b.detach().float() for lin in net.layers()])


def library_sdf(net, ws, bs, pts):
    cfg = net.cfg
    inp = cfg.embed(pts).to(torch.bfloat16)
    h, n = inp, len(ws)
    for l in range(n):
        if l in cfg.skip_in:
            h = torch.cat([h, inp], -1) * (1 / math.sqrt(2))
        w, b = (ws[l][:, :1], bs[l][:1]) if l == n - 1 else (ws[l], bs[l])
        z = torch.matmul(h, w).float() + b
        h = softplus_beta(z).to(torch.bfloat16) if l < n - 1 else z
    return h[:, 0]


def library_render_core(inet, iw, ib, rnet, rw, rb, x, dirs):
    cfg = inet.cfg
    pe = cfg.embed(x)
    inp = pe.to(torch.bfloat16)
    d0 = inp.shape[1]
    h, n, dacts = inp, len(iw), []
    for l in range(n):
        if l in cfg.skip_in:
            h = torch.cat([h, inp], -1) * (1 / math.sqrt(2))
        z = torch.matmul(h, iw[l]).float() + ib[l]
        if l < n - 1:
            dacts.append(torch.sigmoid(100 * z).masked_fill(100 * z > 20, 1)
                         .to(torch.bfloat16))
            h = softplus_beta(z).to(torch.bfloat16)
    sdf, feat = z[:, :1], z[:, 1:]
    r = (iw[-1][:, 0].float() * dacts[-1].float()).to(torch.bfloat16)
    g_pe = torch.zeros_like(pe)
    for l in range(n - 2, -1, -1):
        a = torch.matmul(r, iw[l].t()).float()
        if l in cfg.skip_in:
            a = a / math.sqrt(2)
            g_pe = g_pe + a[:, -d0:]
            a = a[:, :-d0]
        if l > 0:
            r = (a * dacts[l - 1].float()).to(torch.bfloat16)
        else:
            g_pe = g_pe + a
    F = cfg.multires
    f = 2.0 ** torch.arange(F, device=x.device, dtype=torch.float32)
    xf = x[:, :, None] * f
    g_sin = g_pe[:, 3:3 + 3 * F].reshape(-1, 3, F)
    g_cos = g_pe[:, 3 + 3 * F:].reshape(-1, 3, F)
    grad = g_pe[:, :3] + (f * (g_sin * torch.cos(xf)
                               - g_cos * torch.sin(xf))).sum(-1)
    h = torch.cat([rnet.cfg.embed(dirs), feat], -1).to(torch.bfloat16)
    for l in range(len(rw)):
        z = torch.matmul(h, rw[l]).float() + rb[l]
        h = torch.relu(z).to(torch.bfloat16) if l < len(rw) - 1 else z
    return sdf, grad, torch.sigmoid(h)


# ---- phases ---------------------------------------------------------------

def chunk_rays(conf, device, n_rays):
    """The first `n_rays` rays of view 0 at the config's downsample."""
    pd = PlotData(conf.dataset.data_dir, scan_id=conf.dataset.scan_id,
                  data_root=str(ROOT / "data"),
                  downsample=conf.dataset.downsample, indices=[0])
    uv, K, pose, _ = pd.image_inputs(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    inputs = {"uv": t(uv[:n_rays])[None], "intrinsics": t(K)[None],
              "pose": t(pose)[None]}
    dirs, cam = get_camera_params(inputs["uv"], inputs["pose"],
                                  inputs["intrinsics"])
    dirs = dirs.reshape(-1, 3)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return inputs, dirs, cam.expand(dirs.shape[0], 3)


def check_kernels(model, cfg, conf, device) -> list[dict]:
    sc = cfg.sampler
    R = conf.train.split_n_pixels
    _, dirs, cam = chunk_rays(conf, device, R)
    gen = torch.Generator().manual_seed(SEED)
    wk = renderer.KernelWeights.pack(model)
    iw, ib = _bf16_weights(model.implicit)
    rw, rb = _bf16_weights(model.rendering)
    rows = []

    # K1: round 0 of the sampler, 128 evenly spaced depths per ray
    z0 = torch.linspace(0.0, sc.far, sc.eval_counts[0], device=device)
    pts = (cam[:, None] + z0[None, :, None] * dirs[:, None]).reshape(-1, 3)
    pts = pts.contiguous()
    out_k = sdf_mlp.sdf_mlp_nograd(wk.sdf, pts)
    torch.cuda.synchronize()
    out_p = sdf_mlp.sdf_mlp_plain(model.implicit, pts)
    err = float((out_k - out_p).abs().max())
    ok = close(out_k, out_p, 0.02, 0.02)
    dims = cfg.implicit.layer_dims()
    macs = hidden_macs(cfg.implicit) + dims[-2] * 1  # sdf column only
    wbytes = sum(w.numel() for w in iw) * 2
    b_ms, b_by = bound(2.0 * macs * len(pts),
                       len(pts) * 16 + wbytes, PEAK_BF16)
    rows.append(dict(
        name="sdf_mlp_nograd", route="cuda",
        source="i2sdf_tpu_torch/csrc/sdf_mlp.cu",
        replaces="i2sdf_tpu/ops/pallas/fused_mlp.py:157",
        shape=list(pts.shape), max_abs_err=err, atol=0.02, rtol=0.02,
        ms=time_ms(lambda: sdf_mlp.sdf_mlp_nograd(wk.sdf, pts), 10),
        plain_ms=time_ms(lambda: sdf_mlp.sdf_mlp_plain(model.implicit, pts),
                         2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: library_sdf(model.implicit, iw, ib, pts),
                           5)))
    emit_row(rows[-1], ok)

    # K2: the widest set (all 480 samples) in a refinement and the final
    # round; SDF from K1 along the rays, and a wall at depth 3 (what rays
    # of a trained room see: opaque from the surface to the far end)
    S = sum(sc.eval_counts)
    zs = torch.sort(torch.rand((R, S), generator=gen) * sc.far, -1).values
    zs = zs.to(device).contiguous()
    pts2 = (cam[:, None] + zs[..., None] * dirs[:, None]).reshape(-1, 3)
    sdf_mlp_vals = sdf_mlp.sdf_mlp_nograd(wk.sdf, pts2.contiguous())
    noise = 0.1 * torch.randn((R, S), generator=gen).to(device)
    sdf_sets = {"mlp": sdf_mlp_vals.reshape(R, S),
                "wall": (3.0 - zs + noise).contiguous()}
    dz = z0[1:] - z0[:-1]
    beta_init = torch.sqrt((1.0 / (4.0 * math.log(sc.eps + 1.0)))
                           * (dz ** 2).sum()).expand(R).contiguous()
    beta0 = effective_beta(model.beta.detach(), cfg.beta_min)
    for (scene, sdf2), (final, n_out) in itertools.product(
            sdf_sets.items(),
            ((False, sc.eval_counts[-1]), (True, sc.N_samples))):
        u = torch.linspace(0, 1, n_out, device=device).expand(R, n_out)
        u = u.contiguous()
        args = (sc, zs, sdf2, beta_init, beta0, u, final)
        s_k, b_k = sampler_round.sampler_round(*args)
        torch.cuda.synchronize()
        s_p, b_p = sampler_round.sampler_round_plain(*args)
        d = (s_k - s_p).abs()
        err, p99 = float(d.max()), float(torch.quantile(d.flatten(), 0.99))
        mean_err = float((s_k.mean(-1) - s_p.mean(-1)).abs().max())
        ok = (close(b_k, b_p, 1e-6, 1e-4) and p99 < SAMPLES_P99
              and err < SAMPLES_MAX and mean_err < SAMPLES_RAY_MEAN)
        ops = R * S * SAMPLER_OPS_PER_SAMPLE_EVAL * (sc.beta_iters + 2)
        nbytes = 4 * R * (2 * S + 2 * n_out + 2)
        b_ms, b_by = bound(ops, nbytes, PEAK_F32)
        rows.append(dict(
            name="sampler_round", route="cuda",
            source="i2sdf_tpu_torch/csrc/sampler_round.cu",
            replaces="i2sdf_tpu/ops/pallas/sampler_round.py:218",
            sdf=scene, final=final, shape=[R, S, n_out], max_abs_err=err,
            p99=p99,
            ray_mean_err=mean_err,
            beta_max_abs_err=float((b_k - b_p).abs().max()),
            ms=time_ms(lambda: sampler_round.sampler_round(*args), 10),
            plain_ms=time_ms(
                lambda: sampler_round.sampler_round_plain(*args), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        emit_row(rows[-1], ok)

    # K3: the eval forward at the final sample count per ray
    S3 = sc.total_fg_samples - 1
    z3 = torch.linspace(0.0, sc.far, S3, device=device)
    x = (cam[:, None] + z3[None, :, None] * dirs[:, None]).reshape(-1, 3)
    x = x.contiguous()
    dd = dirs[:, None].expand(R, S3, 3).reshape(-1, 3).contiguous()
    k_out = render_core.render_core_fwd(wk.core, x, dd)
    torch.cuda.synchronize()
    p_out = render_core.render_core_plain(model.implicit, model.rendering,
                                          x, dd)
    tols = {"sdf": (0.02, 0.02), "grad": (0.05, 0.08), "rgb": (0.03, 0.05)}
    errs = {k: float((a - b).abs().max())
            for k, a, b in zip(tols, k_out, p_out)}
    ok = all(close(a, b, *tols[k]) for k, a, b in zip(tols, k_out, p_out))
    rdims = cfg.rendering.layer_dims()
    # forward (full head), reverse sweep (the hidden layers transposed),
    # radiance net
    macs = (2 * hidden_macs(cfg.implicit) + dims[-2] * dims[-1]
            + sum(rdims[l] * rdims[l + 1] for l in range(len(rdims) - 1)))
    wbytes = (sum(w.numel() for w in iw) * 2 * 2
              + sum(w.numel() for w in rw) * 2)
    b_ms, b_by = bound(2.0 * macs * len(x), len(x) * 52 + wbytes, PEAK_BF16)
    rows.append(dict(
        name="render_core_fwd", route="cuda",
        source="i2sdf_tpu_torch/csrc/render_core.cu",
        replaces="i2sdf_tpu/ops/pallas/fused_train.py:449",
        shape=list(x.shape), max_abs_err=max(errs.values()),
        errs=errs, tolerances=tols,
        ms=time_ms(lambda: render_core.render_core_fwd(wk.core, x, dd), 5),
        plain_ms=time_ms(lambda: render_core.render_core_plain(
            model.implicit, model.rendering, x, dd), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: library_render_core(
            model.implicit, iw, ib, model.rendering, rw, rb, x, dd), 3)))
    emit_row(rows[-1], ok)
    return rows


def emit_row(row: dict, ok: bool) -> None:
    print(json.dumps({"phase": "kernel", "ok": ok, **row}), flush=True)
    if not ok:
        raise AssertionError(f"{row['name']}: kernel disagrees with its "
                             f"plain version")


def run_slice(model, conf, device) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        res = run_render_eval(model, conf, tmp, data_root=str(ROOT / "data"),
                              indices=[0])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        out = Path(tmp) / "eval"
        depth = np.load(out / "depth" / "0000.npy")
        normal = np.load(out / "normal" / "0000w.npy")
        files = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                       if p.is_file())
    H, W = 480 // conf.dataset.downsample, 640 // conf.dataset.downsample
    assert depth.shape == (H, W) and normal.shape == (H, W, 3), files
    assert np.isfinite(depth).all() and np.isfinite(normal).all()
    assert math.isfinite(res["psnr"]) and math.isfinite(res["ssim"])
    missing = [k for k in EVAL_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched on the eval path: {missing}"
    return dict(launches=launches, psnr=res["psnr"], ssim=res["ssim"],
                render_s=res["seconds"][0], files=files,
                image=[H, W], rays=H * W,
                chunks=math.ceil(H * W / conf.train.split_n_pixels))


def compare_chunk(model, conf, device) -> dict:
    inputs, _, _ = chunk_rays(conf, device, conf.train.split_n_pixels)
    k = renderer.render_rays(model, inputs)
    p = renderer.render_rays(model, inputs, plain=True)
    for out in (k, p):
        for v in out.values():
            assert torch.isfinite(v).all()
    diff = {}
    for key, name in (("rgb_values", "rgb"), ("depth_values", "depth"),
                      ("normal_map", "normal")):
        d = (k[key] - p[key]).abs()
        diff[name] = {"mean_abs": float(d.mean()), "max_abs": float(d.max())}
    mse = float(((k["rgb_values"] - p["rgb_values"]) ** 2).mean())
    psnr = -10 * math.log10(max(mse, 1e-20))
    assert psnr >= SLICE_PSNR_BAR_DB, f"kernel vs plain rgb {psnr:.2f} dB"
    return dict(diff=diff, psnr_db=psnr, bar_db=SLICE_PSNR_BAR_DB)


# ---- K4 and the training path -----------------------------------------------

def loss_cotangents(sdf, grad, rgb, n_eik, seed):
    """Cotangents (N, 7) [grad | sdf | rgb] of the JAX package's kernel-test
    loss (tests/test_pallas_train.py:38-43: rgb L1, sdf^2, normal L1 and
    eikonal against seeded targets) at these outputs; the last n_eik rows
    (eikonal points) keep only the gradient's cotangent."""
    gen = torch.Generator().manual_seed(seed)
    n = sdf.shape[0]
    gt = torch.rand((n, 3), generator=gen).to(sdf.device)
    gn = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                       dim=-1).to(sdf.device)
    s, g, r = (t.detach().requires_grad_(True) for t in (sdf, grad, rgb))
    with torch.enable_grad():
        nrm = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                              min=1e-9)
        loss = ((r - gt).abs().mean() + 0.2 * (s ** 2).mean()
                + 0.5 * (1 - (nrm * gn).sum(-1)).abs().mean()
                + 0.1 * ((torch.linalg.norm(g, dim=-1) - 1) ** 2).mean())
        cs, cg, cr = torch.autograd.grad(loss, (s, g, r))
    cot = torch.cat([cg, cs, cr], 1)
    cot[n - n_eik:, 3:] = 0.0
    return cot.contiguous()


def grad_errors(got, ref) -> dict:
    errs = [float((g - r).abs().max() / max(float(r.abs().max()), 1e-3))
            for g, r in zip(got, ref)]
    a = torch.cat([r.flatten().double() for r in ref])
    b = torch.cat([g.flatten().double() for g in got])
    return {"max_leaf_err": max(errs), "worst_leaf": int(np.argmax(errs)),
            "cos": float(a @ b / (a.norm() * b.norm()))}


def grads_ok(e: dict) -> bool:
    return e["max_leaf_err"] < GRAD_LEAF_TOL and e["cos"] > GRAD_COS_TOL


def k4_macs(icfg, rcfg) -> int:
    """Multiply-adds per point of K4 at the nets' real widths: forward
    recompute (SDF, full head, and radiance), reverse sweep (hidden layers
    1 .. n-2 transposed), radiance backward (every layer transposed),
    upward sweep (layers 0 .. n-2), downward sweep (layers n-1 .. 1), and
    the weight-gradient products (two per SDF layer, one per radiance
    layer)."""
    sd = sdf_layer_macs(icfg)
    n = len(sd)
    rd = rcfg.layer_dims()
    rr = [rd[l] * rd[l + 1] for l in range(len(rd) - 1)]
    return (sum(sd) + sum(rr) + sum(sd[1:n - 1]) + sum(rr)
            + sum(sd[:n - 1]) + sum(sd[1:]) + 2 * sum(sd) + sum(rr))


def library_core_grad(icfg, rcfg, w, x, dirs, cot):
    """The same function as one PyTorch call chain: autograd of the plain
    op with every product a bf16 torch.matmul (autocast)."""
    with torch.autocast("cuda", dtype=torch.bfloat16):
        outs = render_core.render_core_train_plain(icfg, rcfg, w, x, dirs)
    return torch.autograd.grad(outs, w.flat(), (cot[:, 3:4], cot[:, :3],
                                                cot[:, 4:7]))


def check_k4(model, cfg, conf, device) -> dict:
    """K4 at one training step's render-core batch: 1600 rays of view 0 at
    97 depths each, plus 4800 eikonal rows in the scene's cube."""
    sc = cfg.sampler
    _, dirs, cam = chunk_rays(conf, device, K4_RAYS)
    S = sc.total_fg_samples - 1
    z = torch.linspace(0.0, sc.far, S, device=device)
    x = (cam[:, None] + z[None, :, None] * dirs[:, None]).reshape(-1, 3)
    gen = torch.Generator().manual_seed(SEED + 4)
    s = cfg.scene_bounding_sphere
    eik = (torch.rand((K4_EIK, 3), generator=gen) * 2 * s - s).to(device)
    x = torch.cat([x, eik]).contiguous()
    d = torch.cat([dirs[:, None].expand(K4_RAYS, S, 3).reshape(-1, 3),
                   torch.zeros_like(eik)]).contiguous()
    icfg, rcfg = cfg.implicit, cfg.rendering
    w = render_core.CoreWeights.of(model.implicit, model.rendering)
    outs = render_core.render_core_train_plain(icfg, rcfg, w, x, d)
    cot = loss_cotangents(*outs, K4_EIK, SEED + 5)
    cots = (cot[:, 3:4], cot[:, :3], cot[:, 4:7])
    ref = torch.autograd.grad(outs, w.flat(), cots)
    del outs
    with torch.no_grad():
        k = render_core._KernelLayout(icfg, rcfg, w)
        got = render_core.render_core_bwd(k, x, d, cot)
    torch.cuda.synchronize()
    got = [t for grp in got for t in grp]
    errs = grad_errors(got, ref)
    n = x.shape[0]
    wbytes = sum(t.numel() for t in w.flat())
    b_ms, b_by = bound(2.0 * k4_macs(icfg, rcfg) * n,
                       n * 52 + wbytes * (2 + 4), PEAK_BF16)

    def kernel():
        with torch.no_grad():
            render_core.render_core_bwd(k, x, d, cot)

    def plain():
        torch.autograd.grad(render_core.render_core_train_plain(
            icfg, rcfg, w, x, d), w.flat(), cots)

    row = dict(
        name="render_core_bwd", route="cuda",
        source="i2sdf_tpu_torch/csrc/render_core_bwd.cu",
        replaces="i2sdf_tpu/ops/pallas/fused_train.py:449",
        shape=[n, 7], rays=K4_RAYS, samples=S, eikonal_rows=K4_EIK,
        max_abs_err=max(float((g - r).abs().max()) for g, r in
                        zip(got, ref)),
        **errs, leaf_tol=GRAD_LEAF_TOL, cos_tol=GRAD_COS_TOL,
        ms=time_ms(kernel, 5), plain_ms=time_ms(plain, 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: library_core_grad(icfg, rcfg, w, x, d,
                                                     cot), 2))
    emit_row(row, grads_ok(errs))
    return row


# ---- K5 and K6: get_rev_op's forward and backward ---------------------------

def k5_macs(icfg) -> int:
    """K5 per point: the forward with the full head, and the reverse sweep
    through the hidden layers transposed (layers n-2 .. 0)."""
    sd = sdf_layer_macs(icfg)
    return sum(sd) + sum(sd[:-1])


def k6_macs(icfg) -> int:
    """K6 per point: the forward recompute of the hidden layers, the
    reverse sweep (layers n-2 .. 1 transposed), the upward sweep (layers
    0 .. n-2), the downward sweep (layers n-1 .. 1) and the two
    weight-gradient products of every layer."""
    sd = sdf_layer_macs(icfg)
    n = len(sd)
    return (sum(sd[:n - 1]) + sum(sd[1:n - 1]) + sum(sd[:n - 1])
            + sum(sd[1:]) + 2 * sum(sd))


def eikonal_batch(cfg, conf, device, seed):
    """One training step's 4,800 eikonal points as `render_rays_train` makes
    them: a third uniform in the scene's cube, a third at a depth drawn
    among each ray's 97 samples on the first 1600 rays of view 0, and
    those jittered by up to 0.005."""
    _, dirs, cam = chunk_rays(conf, device, K4_RAYS)
    gen = torch.Generator().manual_seed(seed)
    s = cfg.scene_bounding_sphere
    S = cfg.sampler.total_fg_samples - 1
    z = torch.linspace(0.0, cfg.sampler.far, S)
    z_eik = z[torch.randint(0, S, (K4_RAYS,), generator=gen)].to(device)
    uni = (torch.rand((K4_RAYS, 3), generator=gen) * 2 * s - s).to(device)
    near = cam + z_eik[:, None] * dirs
    jit = (torch.rand((K4_RAYS, 3), generator=gen) * 0.01 - 0.005).to(device)
    return torch.cat([uni, near, near + jit]).contiguous()


def render_batch(cfg, conf, device):
    """The 155,200 render points of one training step (1600 rays of view 0
    at 97 depths)."""
    _, dirs, cam = chunk_rays(conf, device, K4_RAYS)
    S = cfg.sampler.total_fg_samples - 1
    z = torch.linspace(0.0, cfg.sampler.far, S, device=device)
    return (cam[:, None] + z[None, :, None] * dirs[:, None]).reshape(
        -1, 3).contiguous()


def rev_cotangents(out, grad, seed):
    """(c_out, c_g) of the JAX package's rev-kernel test loss
    (tests/test_pallas_rev.py:18-23: sdf^2, 0.1 features^2, normal L1
    against seeded targets, eikonal) at these outputs; both non-zero."""
    gen = torch.Generator().manual_seed(seed)
    gn = torch.nn.functional.normalize(torch.randn((out.shape[0], 3),
                                                   generator=gen),
                                       dim=-1).to(out.device)
    o, g = (t.detach().requires_grad_(True) for t in (out, grad))
    with torch.enable_grad():
        nrm = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                              min=1e-9)
        loss = ((o[:, :1] ** 2).mean() + 0.1 * (o[:, 1:] ** 2).mean()
                + 0.5 * (1 - (nrm * gn).sum(-1)).abs().mean()
                + 0.1 * ((torch.linalg.norm(g, dim=-1) - 1) ** 2).mean())
        c_out, c_g = torch.autograd.grad(loss, (o, g))
    return c_out.contiguous(), c_g.contiguous()


def check_rev(model, cfg, conf, device) -> list[dict]:
    """K5 and K6 at the normal-off step's eikonal batch (4,800 points) and
    at 155,200 points, against the plain op (`rev_plain`: f32 autograd
    with create_graph)."""
    icfg = cfg.implicit
    net = model.implicit
    lins = net.layers()
    ws, bs = [l.weight() for l in lins], [l.b for l in lins]
    with torch.no_grad():
        k = rev.RevLayout(icfg, ws, bs)
    n_w = sum(w.numel() for w in ws)
    n_p = n_w + sum(b.numel() for b in bs)
    rows = []
    for label, x in (("eikonal", eikonal_batch(cfg, conf, device, SEED + 8)),
                     ("render", render_batch(cfg, conf, device))):
        n = x.shape[0]
        # K5
        with torch.no_grad():
            got = rev.rev_fwd(k, x)
        torch.cuda.synchronize()
        out_p, grad_p = rev.rev_plain(icfg, ws, bs, x)
        pairs = {"sdf": (got[0][:, :1], out_p[:, :1]),
                 "feat": (got[0][:, 1:], out_p[:, 1:]),
                 "grad": (got[1], grad_p)}
        errs = {name: float((a - b.detach()).abs().max())
                for name, (a, b) in pairs.items()}
        ok = all(close(a, b.detach(), *REV_TOLS[name])
                 for name, (a, b) in pairs.items())
        b_ms, b_by = bound(2.0 * k5_macs(icfg) * n,
                           n * (12 + 4 * k.out_cols + 12) + 2 * 2 * n_w,
                           PEAK_BF16)

        def k5():
            with torch.no_grad():
                rev.rev_fwd(k, x)

        def lib5():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                rev.rev_plain(icfg, ws, bs, x)

        rows.append(dict(
            name="rev_fwd", route="cuda",
            source="i2sdf_tpu_torch/csrc/rev_fwd.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_rev.py:213",
            points=label, shape=[n, 3], max_abs_err=max(errs.values()),
            errs=errs, tolerances=REV_TOLS, ms=time_ms(k5, 5),
            plain_ms=time_ms(lambda: rev.rev_plain(icfg, ws, bs, x), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib5, 3)))
        emit_row(rows[-1], ok)
        # K6
        c_out, c_g = rev_cotangents(out_p, grad_p, SEED + 9)
        ref = torch.autograd.grad((out_p, grad_p), ws + bs, (c_out, c_g))
        del out_p, grad_p
        with torch.no_grad():
            dws, dbs = rev.rev_bwd(k, x, c_out, c_g)
        torch.cuda.synchronize()
        gerrs = grad_errors(dws + dbs, ref)
        b_ms, b_by = bound(2.0 * k6_macs(icfg) * n,
                           n * (12 + 4 * k.out_cols + 12) + 2 * 2 * n_w
                           + 4 * n_p, PEAK_BF16)

        def k6():
            with torch.no_grad():
                rev.rev_bwd(k, x, c_out, c_g)

        def plain6():
            torch.autograd.grad(rev.rev_plain(icfg, ws, bs, x), ws + bs,
                                (c_out, c_g))

        def lib6():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                outs = rev.rev_plain(icfg, ws, bs, x)
            torch.autograd.grad(outs, ws + bs, (c_out, c_g))

        rows.append(dict(
            name="rev_bwd", route="cuda",
            source="i2sdf_tpu_torch/csrc/rev_bwd.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_rev.py:213",
            points=label, shape=[n, 3], cotangents=[k.out_cols, 3],
            max_abs_err=max(float((g - r).abs().max())
                            for g, r in zip(dws + dbs, ref)),
            **gerrs, leaf_tol=GRAD_LEAF_TOL, cos_tol=GRAD_COS_TOL,
            ms=time_ms(k6, 5), plain_ms=time_ms(plain6, 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib6, 2)))
        emit_row(rows[-1], grads_ok(gerrs))
        del ref, c_out, c_g
        torch.cuda.empty_cache()
    return rows


def synthetic_supervision(data, seed, normals=True):
    """Seeded depth (scene units, 0.5 % invalid), with `normals`
    view-space normals (0.5 % zero), and so the bubble point cloud, at the
    scan's shapes."""
    rng = np.random.default_rng(seed)
    n, hw = data.n_images, data.total_pixels
    depth = rng.uniform(0.5, 4.5, (n, hw)).astype(np.float32)
    depth[rng.uniform(size=(n, hw)) < 0.005] = 0.0
    data.use_depth = data.use_bubble = True
    data.set_depth(depth)
    if normals:
        nmaps = rng.normal(size=(n, hw, 3)).astype(np.float32)
        nmaps[rng.uniform(size=(n, hw)) < 0.005] = 0.0
        data.use_normal = True
        data.set_normals(nmaps)


def train_conf():
    conf = load_cfg(str(TRAIN_CONF))
    conf.dataset.scan_id = 1
    conf.loss.min_bubble_iter = 2
    conf.loss.max_bubble_iter = 4
    conf.train.uniform_bubble = True
    return conf


def kernel_vs_plain_step(tr) -> dict:
    """One batch with bubble points through a kernel step and a plain step
    from the same weights and draws."""
    cfg, data = tr.model_cfg, tr.device_data
    P = data.pointcloud.shape[0]
    gen = train_step.step_generator(SEED + 7, 0, tr.device)
    draws = train_step.TrainDraws.sample(cfg, data, tr.batch_size, gen,
                                         bubble_draws=tr.batch_size)
    # every loss the config weighs on together: the normal loss (off
    # inside the bubble window; zero with normal_weight 0) and the bubble
    # loss
    weights = dict(tr.loss_cfg.dynamic_weights(0),
                   bubble=tr.loss_cfg.bubble_weight)
    res = {}
    for plain in (False, True):
        model = copy.deepcopy(tr.state.model)
        state = create_train_state(model, learning_rate=5e-4)
        step = train_step.make_train_step(cfg, tr.batch_size, plain=plain)
        bub = train_step.BubbleState(
            pdf=torch.ones(P, device=tr.device),
            sample_count=torch.zeros(P, dtype=torch.int64, device=tr.device))
        m = step(state, data, draws, weights, bub)
        res[plain] = ({k: float(v) for k, v in m.items()},
                      [p.grad for p in model.parameters()])
    mk, gk = res[False]
    mp, gp = res[True]
    term_err = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-6) for k in mp}
    errs = grad_errors(gk, gp)
    ok = grads_ok(errs) and all(
        v < GRAD_LEAF_TOL for k, v in term_err.items() if k != "psnr")
    out = dict(kernel_terms=mk, plain_terms=mp, term_rel_err=term_err,
               **errs, ok=ok)
    assert ok, f"kernel step vs plain step: {out}"
    return out


def profile_steps(tr, step0: int, n: int = 2) -> dict:
    """torch.profiler over n training steps: device time by kernel, busy
    and idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(step0, step0 + n):
            tr.step_fn(tr.state, tr.device_data, tr.draws(s),
                       tr.loss_cfg.dynamic_weights(s), tr.bubble)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # K3 and K5 are one kernel template, K4 and K6 another, told apart by
    # the template argument (true: with the radiance net); the products
    # and sums are K4's on the normal-on path, K6's on the other
    groups = {"K1 sdf_mlp": "sdf_mlp_kernel", "K2 sampler_round":
              "sampler_round", "K3 render_core_fwd": "fwd_sweep_kernel<true>",
              "K5 rev_fwd": "fwd_sweep_kernel<false>",
              "K4 sweep": "bwd_sweep_kernel<true>",
              "K6 sweep": "bwd_sweep_kernel<false>",
              "K4/K6 atb": "atb_kernel", "K4/K6 sum": "sum_kernel"}
    by = {g: 0.0 for g in groups}
    by["other"] = 0.0
    top = []
    for e in prof.key_averages():
        # kernels only: an operator's own entry also counts the kernels
        # it launched (the autograd functions around K3 and K4 do)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if dev <= 0:
            continue
        top.append((dev, e.key[:60], e.count))
        g = next((g for g, k in groups.items() if k in e.key), "other")
        by[g] += dev
    busy = sum(by.values())
    top.sort(reverse=True)
    return dict(steps=n, wall_ms_per_step=wall_ms / n,
                device_ms_per_step={k: v / n for k, v in by.items()},
                device_ms_total_per_step=busy / n,
                device_busy_share=busy / wall_ms,
                top=[dict(ms=t / n, name=k, calls=c) for t, k, c in top[:12]])


def images_only_root(tmp) -> str:
    """A data root whose scan1 holds only the checkout's images and
    cameras (symlinks), so no depth, normal or light-mask file is read
    wherever this runs."""
    src = ROOT / "data" / "synthetic_quality" / "scan1"
    scan = Path(tmp) / "data" / "synthetic_quality" / "scan1"
    scan.mkdir(parents=True)
    for name in ("image", "cameras_normalize.npz"):
        os.symlink(src / name, scan / name)
    return str(Path(tmp) / "data")


def run_train(device, normal: bool = True) -> dict:
    """6 steps through the trainer. With `normal` off (`normal_weight: 0`,
    no normal maps) the step takes the rev route: K5 and K6 once a step,
    K3 and K4 never (counted around each step; the validation render at
    the end of `fit` runs the eval path, K1-K3)."""
    conf = train_conf()
    if not normal:
        conf.loss.normal_weight = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        tr = ReconstructionTrainer(conf, os.path.join(tmp, "exp"),
                                   data_root=images_only_root(tmp),
                                   device=device, seed=SEED)
        data = tr.train_data
        assert tr.device_data.depth is None and tr.device_data.normal is None
        assert tr.model_cfg.use_normal == normal
        synthetic_supervision(data, SEED + 6, normals=normal)
        tr.device_data = data.to_device(device)
        times, seen, per_step = [], [], []
        inner = tr.step_fn

        def timed(state, d, draws, weights, bubble=None):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            m = inner(state, d, draws, weights, bubble)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = kernels.launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            seen.append(({k: float(v) for k, v in m.items()},
                         bubble is not None))
            return m

        tr.step_fn = timed
        kernels.reset_launch_counts()
        tr.fit(max_steps=TRAIN_STEPS, log_every=1)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        tr.step_fn = inner
        assert [b for _, b in seen] == [False, False, True, True, False,
                                        False], seen
        for m, _ in seen:
            assert all(math.isfinite(v) for v in m.values()), m
        assert seen[2][0]["bubble_loss"] > 0 and seen[0][0]["depth_loss"] > 0
        want = TRAIN_KERNELS if normal else NONORMAL_KERNELS
        missing = [k for k in want if launches[k] == 0]
        assert not missing, f"kernels not launched on the path: {missing}"
        if normal:
            assert launches["render_core_bwd"] == TRAIN_STEPS, launches
        else:
            for c in per_step:
                assert c["rev_fwd"] == c["rev_bwd"] == 1, c
                assert c["render_core_fwd"] == c["render_core_bwd"] == 0, c
                assert 1 <= c["sdf_mlp_nograd"] <= 5, c
                assert 2 <= c["sampler_round"] <= 5, c
            for m, _ in seen:
                assert m["normal_loss"] == m["angular_loss"] == 0.0, m
        ckpts = sorted(os.listdir(os.path.join(tmp, "exp", "checkpoints")))
        assert ckpts == [f"step_{TRAIN_STEPS}.pt"], ckpts
        try:
            prof = profile_steps(tr, TRAIN_STEPS)
        except Exception as exc:  # the profiler is a measurement only
            prof = {"error": repr(exc)}
        cmp = kernel_vs_plain_step(tr)
        steady = times[1:]
        if "device_ms_total_per_step" in prof:
            # the profiler slows the host; against the unprofiled step
            prof["busy_share_of_median_step"] = (
                prof["device_ms_total_per_step"]
                / (statistics.median(steady) * 1e3))
        out = dict(
            launches=launches, launches_per_step=per_step,
            steps=TRAIN_STEPS, rays=tr.batch_size,
            # 97 samples and 3 eikonal points a ray
            points=tr.batch_size * (tr.model_cfg.sampler.total_fg_samples
                                    - 1 + 3),
            step_s=times, step_s_median=statistics.median(steady),
            rays_per_s=tr.batch_size / statistics.median(steady),
            losses=[m["loss"] for m, _ in seen],
            pointcloud=int(data.pointcloud.shape[0]),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            profile=prof, kernel_vs_plain=cmp)
        del tr
    torch.cuda.empty_cache()
    return out


def run_cli() -> dict:
    """The train CLI on scan1 as the checkout holds it (images and cameras
    only), then --resume for one step, then the render CLI with no --ckpt,
    which loads the newest checkpoint; last the train CLI on a copy of the
    config with the normal losses off."""
    with tempfile.TemporaryDirectory() as tmp:
        cli = [sys.executable, "-m", "i2sdf_tpu_torch.main", "--scan_id",
               "1", "--data_root", images_only_root(tmp), "--log_every", "1"]
        base = cli + ["--conf", str(TRAIN_CONF), "--exps_folder",
                      str(Path(tmp) / "exps")]
        runs = []
        for extra in (["--max_steps", "3"],
                      ["--max_steps", "4", "--resume"],
                      ["--test", "--test_mode", "render", "--indices", "0"]):
            t0 = time.perf_counter()
            proc = subprocess.run(base + extra, cwd=ROOT, capture_output=True,
                                  text=True, timeout=600)
            runs.append(dict(args=extra, rc=proc.returncode,
                             seconds=time.perf_counter() - t0,
                             tail=proc.stdout.strip().splitlines()[-4:]))
            assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[
                -3000:]
            if "--resume" in extra:
                assert "[INFO] Resumed from step 3" in proc.stdout, \
                    proc.stdout
        assert "[INFO] restored checkpoint @4" in proc.stdout, proc.stdout
        # the normal-off route through the CLI: a copy of the config with
        # normal_weight 0, in its own experiments folder
        nonormal = Path(tmp) / "quality_nonormal.yml"
        nonormal.write_text(TRAIN_CONF.read_text().replace(
            "normal_weight: 0.05", "normal_weight: 0.0"))
        args = ["--conf", str(nonormal), "--exps_folder",
                str(Path(tmp) / "exps_nonormal"), "--max_steps", "2"]
        t0 = time.perf_counter()
        proc = subprocess.run(cli + args, cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        logs = [ln for ln in proc.stdout.splitlines() if "[scan1 " in ln]
        runs.append(dict(args=args, rc=proc.returncode,
                         seconds=time.perf_counter() - t0, tail=logs))
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[
            -3000:]
        assert len(logs) == 2 and not any(
            t in ln for ln in logs for t in ("normal=", "angular=")), logs
        exp = Path(tmp) / "exps" / "quality_1" / "version_0"
        ckpts = sorted(os.listdir(exp / "checkpoints"))
        plots = sorted(str(p.relative_to(exp)) for p in (exp / "plots")
                       .rglob("*.png"))
        depth = np.load(exp / "eval" / "depth" / "0000.npy")
        normal = np.load(exp / "eval" / "normal" / "0000w.npy")
        evals = sorted(str(p.relative_to(exp / "eval"))
                       for p in (exp / "eval").rglob("*") if p.is_file())
    assert ckpts == ["step_3.pt", "step_4.pt"], ckpts
    assert len(plots) == 6, plots
    assert np.isfinite(depth).all() and np.isfinite(normal).all()
    assert depth.ndim == 2 and normal.shape == depth.shape + (3,)
    return dict(runs=runs, checkpoints=ckpts, plots=plots,
                rendered_step=4, eval_files=evals, image=list(depth.shape))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit("device", t0, name=name, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t0 = time.perf_counter()
    path, nvcc_s = build.build()
    build.load_library()
    emit("build", t0, nvcc_seconds=nvcc_s, library=path.name)

    conf = load_cfg(str(CONF))
    conf.dataset.data_dir = "synthetic_quality"
    conf.dataset.scan_id = 1
    cfg = renderer.I2SDFConfig.from_cfgnode(conf.model)
    model = renderer.I2SDFModel(cfg, seed=SEED).to(device)

    t0 = time.perf_counter()
    rows = check_kernels(model, cfg, conf, device)
    tconf = train_conf()
    tcfg = renderer.I2SDFConfig.from_cfgnode(tconf.model)
    tmodel = renderer.I2SDFModel(tcfg, seed=SEED).to(device)
    rows.append(check_k4(tmodel, tcfg, conf, device))
    torch.cuda.empty_cache()
    rows += check_rev(tmodel, tcfg, conf, device)
    del tmodel
    emit("kernels", t0, n=len(rows))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sl = run_slice(model, conf, device)
    emit("slice", t0, **sl)

    t0 = time.perf_counter()
    cmp = compare_chunk(model, conf, device)
    emit("compare", t0, **cmp)
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tr = run_train(device)
    emit("train", t0, **tr)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trn = run_train(device, normal=False)
    emit("train_nonormal", t0, **trn)

    t0 = time.perf_counter()
    cli = run_cli()
    emit("cli", t0, **cli)

    per_kernel = {}
    for row in rows:  # one entry per kernel: its main-path shape's row
        per_kernel.setdefault(row["name"], row)
    # each kernel's launches from the training path it serves: K1-K4 the
    # normal-on step's (`train`), K5/K6 the normal-off step's
    path_of = {k: "train_nonormal" if k.startswith("rev_") else "train"
               for k in per_kernel}
    paths = {"train": tr["launches"], "train_nonormal": trn["launches"]}
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"launches": {"eval": sl["launches"],
                                   "train": tr["launches"],
                                   "train_nonormal": trn["launches"]},
                      "seconds": time.perf_counter() - t_all}))
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         "launches": paths[path_of[r["name"]]][r["name"]],
         "launches_path": path_of[r["name"]]}
        for r in per_kernel.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
