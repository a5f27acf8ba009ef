"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its wall time:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit;
2. build: the three CUDA kernels (`i2sdf_tpu_torch/csrc/*.cu`) in one
   `nvcc` call;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the flagship eval render gives it, with the stated
   tolerance; kernel, plain and library-yardstick times by CUDA events;
4. slice: one 240x320 view of `data/synthetic_quality/scan1` rendered
   through the port's eval entry point (`eval/render.py`) at the full width
   of `configs/synthetic.yml`, seeded init weights; every output finite and
   every kernel launched; then the first 12000-ray chunk rendered again
   through the plain path, held against the kernels' render.

The card's `nvidia-smi` line is printed on its own after phase 1. The
run ends with the launch counts, one JSON line with every kernel's
numbers, and last `{"ok": true, "device": {...}}`. Any failure raises
and exits nonzero; with no CUDA device the script exits nonzero before
printing a result. All
files are written to a temporary directory.

Precision: the plain path is f32 throughout, with TF32 turned off for
matmuls and cuDNN; the kernels take bf16 operands with f32 accumulation.
"""

from __future__ import annotations

import itertools
import json
import math
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
from i2sdf_tpu_torch.ops.kernels import (build, render_core, sampler_round,
                                         sdf_mlp)
from i2sdf_tpu_torch.utils.cameras import get_camera_params

ROOT = Path(__file__).resolve().parent
CONF = ROOT / "configs" / "synthetic.yml"
SEED = 0
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
    dims = icfg.layer_dims()
    return sum(dims[l] * (dims[l + 1] - (dims[0] if l + 1 in icfg.skip_in
                                         else 0))
               for l in range(len(dims) - 2))


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
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
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
    emit("kernels", t0, n=len(rows))

    t0 = time.perf_counter()
    sl = run_slice(model, conf, device)
    emit("slice", t0, **sl)

    t0 = time.perf_counter()
    cmp = compare_chunk(model, conf, device)
    emit("compare", t0, **cmp)

    per_kernel = {}
    for row in rows:  # one entry per kernel: its main-path shape's row
        per_kernel.setdefault(row["name"], row)
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"launches": sl["launches"],
                      "seconds": time.perf_counter() - t_all}))
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, "launches": sl["launches"][r["name"]]}
        for r in per_kernel.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
