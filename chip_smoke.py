"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its wall time:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit;
2. build: the CUDA kernels (`i2sdf_tpu_torch/csrc/*.cu`), one
   `nvcc` per source, all started together, and one link;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the flagship eval render (K1-K3) and training steps give it
   (K4: 160,000 points with the cotangents of a seeded loss; K5 and K6:
   the normal-off step's 4,800 eikonal points, and 155,200 points, the
   size the JAX renderer feeds the op on its other training route), and
   K3 and K4 with the light head at the light config's eval chunk and
   training batch (both `detach_light` values for K4), K7 at the perray
   config's training shape (1600 x 416) and an eval chunk (12,000 x 416),
   its flag also against one K2 launch's beta0 decision on the same rows
   (both of K2's scenes, S 416 and 480),
   K8 at the bg config's training batch (51,200 points) and eval chunk
   (384,000), K9 at the training batch with a seeded loss's cotangents
   (both also at perturbed and odd-depth nets and at the block-edge
   counts, K9 twice to the same bits, `check_bg`), K2 also at the
   training step's 1,600 rays (its checks at both shapes, both scenes
   and both `final`), K5 and K6 on one pack, also at a perturbed net and
   a net of odd depth (K5 there against the plain op at bf16-rounded
   weights) and against their bf16 replays (`ops/kernels/replay.py`, on
   the card's tensors), twice to the same bits, with padding rows that
   change no real row of K5's output and zero-cotangent rows that add
   nothing to K6's (`check_rev`),
   K10 at the first eval chunk's 1,164,000 sample points (both sides of
   the bounding-sphere clamp) at the init's weights, at weights perturbed
   by 0.01 N(0, 1) and on perturbed nets of seven and five hidden layers,
   against its bf16 replay and at block-edge counts to the full run's
   bits (`check_sdf_outputs`), K11 and K12 at the normal-off step's 4,800
   eikonal points and at 155,200, each at the init's and the perturbed
   weights, where three tangent faults planted in the plain op must fail
   the same check, K11 also against K5 and K12 (K6 under its own name)
   against K6 bit for bit; K1 also at
   weights perturbed by 0.01 N(0, 1) against the f32 plain version, K3
   and K3-light also at perturbed weights and on nets with one SDF
   hidden layer fewer (an odd count, `odd_nets`) against the plain
   version at the weights rounded to bf16 (the f32 reading and the points
   past the f32 bound reported; `scripts/witness_perturbed.py` holds the
   JAX package's own kernels to the same bounds), and at EDGE_COUNTS
   points, both sides of their blocks' edges; K4 and K4-light also at
   perturbed weights and on `odd_nets`, all against the f32 plain
   backward, and twice to the same bits; each with the stated tolerance;
   kernel, plain and library-yardstick times by CUDA events, K1's and
   K3's L2 weight traffic as modelled from the pack
   (`l2_weight_gb_model`: blocks x stage-image bytes, not a reading), K3's,
   K10's, K11's and K12's design work (`design_macs`) beside the
   function's least work that their bounds count (`macs`), K4's, K5's,
   K6's and K12's scratch (`staging_gb`), the profiler's device time of
   K2, K5, K6, K7, K10 and K12 (`device_ms`), K2's and K7's bounds with
   the exponentials on the SFU (`bound_f32`), and K2's, K4's, K5's, K6's,
   K7's and K10's kernels' registers, spills, HGMMA, MUFU and bulk copies
   (`scripts/kernel_resources.py`, started beside the checks);
4. sdf_outputs (the path of K10-K12, whose JAX counterparts only the JAX
   package's public kernel API reaches): `fused_sdf_outputs` under no_grad
   over the first eval chunk's sample points, and `sdf_outputs_fused_grad`
   inside one backward of the JAX package's tangent-kernel test loss over
   the eikonal batch, at the full width of `configs/synthetic.yml`: every
   output finite, unit normals where the gradient is non-zero, every SDF
   leaf's gradient finite and non-zero, K10, K11 and K12 launched once
   each and no other kernel;
5. slice (the eval path): one 240x320 view of `data/synthetic_quality/
   scan1` rendered through the port's eval entry point (`eval/render.py`)
   at the full width of `configs/synthetic.yml`, seeded init weights;
   every output finite and every kernel of the path launched; then the
   first 12000-ray chunk rendered again through the plain path, held
   against the kernels' render;
6. train (the training path): `ReconstructionTrainer.fit` for 6 steps of
   `configs/synthetic_quality.yml` at full width (1600 rays a step) on
   scan1's images and cameras, with seeded synthetic depth, normals and
   bubble point cloud at scan1's shapes (the checkout holds no `depth/`
   or `normal/`), the bubble window open for steps 2-3 with a uniform pdf;
   every loss finite, K1-K4 launched, K4 once a step; a profile
   of two steps; two more steps' wall time split by cause (`host_split`:
   the host syncs, the weight packing, the Python step, the wait for the
   device at the step's end), and the median of steps 1-5 and the mean of
   steps 4-5 (`median_ms`, `steps45_ms`); then one batch through a kernel
   step and a plain step from the same weights and draws, loss terms and
   gradients held to the JAX package's gradient tolerance (the other
   training phases likewise);
7. train_nonormal (the normal-loss-off training path): the same trainer,
   config and synthetic depth and bubble cloud with `normal_weight: 0`,
   which routes the render points through the plain nets and the
   eikonal points through K5/K6; every loss finite, per step K5 and K6
   once, K3 and K4 never, K1 and K2 at most five times (one a sampler
   round); a profile of two steps; one batch through a kernel step and a
   plain step;
8. eval_light (the light-mask config's eval path): one 240x320 view of
   scan1 through the eval entry point at the full width of
   `configs/synthetic_light_mask.yml` (SDF 6 x 256, radiance 3 x 256,
   light 256 -> 128 -> 1), seeded init weights: every output finite, K1,
   K2 and K3 with the light head launched (K3 without it never); then the
   first chunk through the plain path, its rgb and light mask held to the
   kernels';
9. train_light: the trainer for 6 steps of a copy of the light config at
   full width on scan1 with seeded light masks (grey PNGs at scan1's
   shape, written to the temporary scene) and the `train` phase's seeded
   depth, normals and bubble cloud: K3 and K4 with the light head once a
   step (without it never), `light_mask_loss` > 0 at every step, every
   light-net leaf moved; a profile of two steps; one batch through a
   kernel step and a plain step;
10. eval_perray: one 240x320 view of scan1 through the eval entry point
   with the perray config (`synthetic_quality.yml` with
   `ray_sampler.per_ray_exit` and `per_ray_fracs` pinned to [1.0, 0.5,
   0.5, 0.5]; the beta ladder would not compact at the seeded init's
   beta): K7 four times a chunk, and K1/K2 on the capped rows after the
   first compacted round (the sizes they saw are recorded); then the
   first chunk through the plain path;
11. train_perray: the trainer for 6 steps of the perray config: K7 four
   times a step, K3/K4 once, every loss finite; a profile of two steps;
   one batch through a kernel step and a plain step;
12. eval_bg: one view of the bg config (`synthetic_quality.yml` with the
   NeRF++ background of VolSDF's BlendedMVS config, `BG_BLOCK`): K8 once
   a chunk, K9 never; then the first chunk through the plain path;
13. train_bg: the trainer for 6 steps of the bg config: K8 and K9 once a
   step beside K1-K4, every background leaf moved; a profile of two
   steps; one batch through a kernel step and a plain step;
14. cli: `python -m i2sdf_tpu_torch.main` in train mode for 3 steps on
   scan1 as the checkout holds it (images and cameras only), then
   `--resume` for one more step from the checkpoint it wrote, then
   `--test --test_mode render --indices 0` with no `--ckpt`, which must
   load that newest checkpoint (step 4) and write finite images; then the
   train CLI for 2 steps on a copy of the config with `normal_weight: 0`
   in the temporary directory, whose logs carry no normal term; last the
   train CLI for 2 steps on a copy of the light config (with seeded light
   masks), whose logs carry the light-mask term and whose validation
   writes a light-mask plot, and the render CLI on its newest checkpoint;
   and the train CLI for 2 steps on the bg config and the render CLI on
   its newest checkpoint.

The card's `nvidia-smi` line is printed on its own after phase 1. The
run ends with the launch counts of each path, one JSON line with every
kernel's numbers (launches from the path it serves), and last
`{"ok": true, "device": {...}}`. Any failure raises and exits nonzero;
with no CUDA device the script exits nonzero before printing a result.
All files are written to a temporary directory; no scene file under
`depth/`, `normal/`, `light_mask/` or `mesh.ply` is read (the light masks
are written by the script).

Precision: the plain path is f32 throughout, with TF32 turned off for
matmuls and cuDNN; the kernels take bf16 operands with f32 accumulation.
"""

from __future__ import annotations

import copy
import dataclasses
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
from i2sdf_tpu_torch.models import mlp, renderer
from i2sdf_tpu_torch.models.density import effective_beta
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops import kernels
from i2sdf_tpu_torch.models import sampler as tsampler
from i2sdf_tpu_torch.ops.kernels import (bg_core, build, conv_check,
                                         render_core, replay, rev,
                                         sampler_round, sdf_grad, sdf_mlp,
                                         sdf_outputs)
from i2sdf_tpu_torch.train import step as train_step
from i2sdf_tpu_torch.train.state import create_train_state
from i2sdf_tpu_torch.train.trainer import ReconstructionTrainer
from i2sdf_tpu_torch.utils import imaging
from i2sdf_tpu_torch.utils.cameras import get_camera_params

ROOT = Path(__file__).resolve().parent
CONF = ROOT / "configs" / "synthetic.yml"
TRAIN_CONF = ROOT / "configs" / "synthetic_quality.yml"
LIGHT_CONF = ROOT / "configs" / "synthetic_light_mask.yml"
SEED = 0
EVAL_KERNELS = ("sdf_mlp_nograd", "sampler_round", "render_core_fwd")
TRAIN_KERNELS = EVAL_KERNELS + ("render_core_bwd",)
NONORMAL_KERNELS = ("sdf_mlp_nograd", "sampler_round", "rev_fwd", "rev_bwd")
EVAL_LIGHT_KERNELS = ("sdf_mlp_nograd", "sampler_round",
                      "render_core_fwd_light")
LIGHT_KERNELS = EVAL_LIGHT_KERNELS + ("render_core_bwd_light",)
EVAL_PERRAY_KERNELS = EVAL_KERNELS + ("conv_check",)
PERRAY_KERNELS = TRAIN_KERNELS + ("conv_check",)
EVAL_BG_KERNELS = EVAL_KERNELS + ("bg_core_fwd",)
BG_KERNELS = TRAIN_KERNELS + ("bg_core_fwd", "bg_core_bwd")
SDF_OUTPUTS_KERNELS = ("sdf_outputs", "sdf_grad_fwd", "sdf_grad_bwd")
# the perray config's pinned capacities (the beta ladder gives None at the
# seeded init's beta 0.1, so it would never compact)
PER_RAY_FRACS = (1.0, 0.5, 0.5, 0.5)
# the bg config's background: the NeRF++ nets of VolSDF's BlendedMVS config
# (`confs/bmvs.conf`, `bg_network`) in this repo's schema
BG_BLOCK = """    bg_network:
        feature_vector_size: 256
        implicit_network:
            d_in: 4
            d_out: 1
            dims: [256, 256, 256, 256, 256, 256, 256, 256]
            geometric_init: False
            skip_in: [4]
            weight_norm: False
            embed_type: positional
            multires: 10
        rendering_network:
            mode: nerf
            d_in: 3
            d_out: 3
            dims: [128]
            weight_norm: False
            embed_type: positional
            multires: 4

"""
# K7 against its plain version: both f32 with sums in other orders, so a
# ray whose f64 bound lies within 1e-4 relative of eps may flip; flags must
# agree outside that band, and under 1 % of the rays may lie in it
CONV_BAND, CONV_BAND_SHARE = 1e-4, 0.01
# K8 against its plain version, besides CORE_TOLS: each output's max error
# at most this share of the spread of the plain output over the points
# (max - min). At init the pair's outputs vary little from point to point,
# so an absolute tolerance alone would pass a kernel that lost the features
# or PE(view); the check runs at the model's weights and at copies scaled
# by BG_SIGNAL_GAIN (the uniform init's std times sqrt(6) is He's
# sqrt(2 / fan_in), so the outputs vary by O(1)), where each output's
# spread must be at least BG_MIN_SPREAD and each planted fault of
# `bg_faults` must fail the check.
BG_SPREAD_TOL = 0.05
BG_SIGNAL_GAIN = math.sqrt(6.0)
BG_MIN_SPREAD = 0.25
# K8 and K9 are checked at these counts too: both sides of their blocks'
# edges (K8 128 points a block, two warpgroups of 64; K9 64)
BG_EDGE_COUNTS = (1, 63, 64, 65, 127, 128, 129, 4800)
# f32 operations per sample of the convergence check (d*, the Laplace
# density, two scan steps, the bound, the max), counted from
# csrc/ray_common.cuh
CONV_OPS_PER_SAMPLE = 25
TRAIN_STEPS = 6          # bubble window [2, 4): off, off, on, on, off, off
K4_RAYS, K4_EIK = 1600, 4800   # one training step's render-core batch
# K5 against its plain version: the JAX package's tolerances for its rev
# kernel (tests/test_pallas_rev.py), (atol, rtol)
REV_TOLS = {"sdf": (0.02, 0.02), "feat": (0.05, 0.05), "grad": (0.05, 0.08)}
# K5 against its bf16 replay (`replay.K5Replay`, run on the card's
# inputs): the absolute gaps whose counts of points past them are
# reported (`replay_gaps`), and the gate (`replay_ok`): at most the share
# of the points (rounded up) may have an entry past the gap. The card's
# f32 sums run in another order and its sinf/expf are its own, so now and
# then a bf16 rounding flips and moves a point; over the three nets and
# both point sets at most 8.8 % of the points were past 0.003 and 1.0 %
# past 0.01 (`PERF.md` §6). Dropping layer 0's low half of the encoding
# puts 57-97 % past 0.003 and 5-55 % past 0.01 in the CPU replay;
# dropping the skip's share of the gradient, every point past 0.03.
REPLAY_GAPS = (1e-4, 1e-3, 3e-3, 1e-2, 3e-2)
REPLAY_GATE = ((3e-3, 0.20), (1e-2, 0.025))
# K10 and K11 against their plain versions: the JAX package's tolerances
# for its tangent-stream kernels (tests/test_pallas_outputs.py:39-49),
# (atol, rtol), and each point's gradient cosine
TAN_TOLS = REV_TOLS
TAN_COS_TOL = 0.995
# ... held where the plain gradient's norm is at least this: below it bf16's
# error can turn a short gradient past the bound, and the JAX kernel's own
# gradient does so (tests/test_torch_parity_sdf_outputs.py::
# test_flagship_perturbed_matches_pallas_interpret)
TAN_COS_MIN_NORM = 0.5
# K3 (and K3 with the light head) against its plain version: the JAX
# package's tolerances for its render kernel (tests/test_pallas_train.py:
# 73-77, 171-176), (atol, rtol)
CORE_TOLS = {"sdf": (0.02, 0.02), "grad": (0.05, 0.08), "rgb": (0.03, 0.05),
             "lmask": (0.02, 0.03)}
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
# ... and the exponentials among them, which run on the special-function
# units (MUFU.EX2), not the FMA pipes: the Laplace density's expm1f, the d*
# term's expf and the bound's two expf (the pdf pass: three or four);
# the same four in K7's evaluation (csrc/ray_common.cuh)
EXP_PER_SAMPLE_EVAL = 4
# the H100's SFU rate: 16 results a clock an SM on 132 SMs, at the SM
# clock `nvidia-smi` reports (clocks.max.sm)
SFU_PER_CLOCK_SM, N_SMS = 16, 132
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
# K1 and K3 are checked at these counts too: both sides of their blocks'
# edges (K1 128 points a block, two warpgroups of 64; K3 32)
EDGE_COUNTS = (1, 31, 33, 127, 129, 4097)
K1_POINTS, K3_POINTS = 128, 32
# K10 is checked at these counts too: both sides of its blocks' edges (32
# points a block, K3's) and one count that is not a multiple of 32
K10_EDGE_COUNTS = (1, 31, 32, 33, 4097)


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


_SFU_RATE: list = []


def sfu_rate() -> float:
    """Exponentials a second the card's special-function units give."""
    if not _SFU_RATE:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True)
        mhz = float(out.stdout.strip().splitlines()[0])
        _SFU_RATE.append(SFU_PER_CLOCK_SM * N_SMS * mhz * 1e6)
    return _SFU_RATE[0]


def bound_f32(flops: float, exps: float,
              nbytes: float) -> tuple[float, str]:
    """`bound` for f32 kernels whose exponentials run on the SFU: the
    operations' time is the larger of the FMA pipes' (flops over the f32
    peak) and the SFU's (exponentials over `sfu_rate`)."""
    t_ops = max(flops / PEAK_F32, exps / sfu_rate()) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


PROFILE_TRIES = 3   # traces `device_ms` takes before it gives up


def device_ms(fn, reps: int, key) -> float | None:
    """The profiler's device time a call of fn of the kernels whose names
    hold `key` (or one of a tuple of keys, the first naming the kernel fn
    launches once a call), over reps calls after one more: the total over
    the calls the trace holds, each counted by its first kernel (a trace
    late in a long process has been seen to hold 2 of 5 calls, and none:
    then it is taken again, up to PROFILE_TRIES times, and None, not
    measured, if no trace holds a call)."""
    from torch.profiler import ProfilerActivity, profile
    keys = (key,) if isinstance(key, str) else tuple(key)
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, calls = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in e.key for k in keys)):
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                calls += e.count if keys[0] in e.key else 0
        if calls:
            return total / 1e3 / calls
    return None


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


def library_render_core(inet, iw, ib, rnet, rw, rb, x, dirs, lw=None,
                        lb=None):
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
    outs = (sdf, grad, torch.sigmoid(h))
    if lw is None:
        return outs
    h = torch.relu(feat).to(torch.bfloat16)
    for l in range(len(lw)):
        z = torch.matmul(h, lw[l]).float() + lb[l]
        h = softplus_beta(z).to(torch.bfloat16) if l < len(lw) - 1 else z
    return outs + (torch.sigmoid(h),)


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


def eval_conf():
    """`configs/synthetic.yml` on scan1 of the checkout."""
    conf = load_cfg(str(CONF))
    conf.dataset.data_dir = "synthetic_quality"
    conf.dataset.scan_id = 1
    return conf


def seeded_model(conf, device):
    """The config's model config and its model at the smoke's seed."""
    cfg = renderer.I2SDFConfig.from_cfgnode(conf.model)
    return cfg, renderer.I2SDFModel(cfg, seed=SEED).to(device)


def k1_points(cfg, conf, device):
    """K1's points: round 0 of the sampler over one eval chunk, the
    round's evenly spaced depths on each ray."""
    _, dirs, cam = chunk_rays(conf, device, conf.train.split_n_pixels)
    z0 = torch.linspace(0.0, cfg.sampler.far, cfg.sampler.eval_counts[0],
                        device=device)
    pts = (cam[:, None] + z0[None, :, None] * dirs[:, None]).reshape(-1, 3)
    return pts.contiguous()


def k2_errors(got, ref) -> tuple[dict, bool]:
    """K2's outputs (samples, beta) against the plain round's: beta at rtol
    1e-4 / atol 1e-6, the samples' p99, max and per-ray mean error."""
    (s_k, b_k), (s_p, b_p) = got, ref
    d = (s_k - s_p).abs()
    errs = dict(max_abs_err=float(d.max()),
                p99=float(torch.quantile(d.flatten(), 0.99)),
                ray_mean_err=float((s_k.mean(-1) - s_p.mean(-1)).abs().max()),
                beta_max_abs_err=float((b_k - b_p).abs().max()))
    ok = (close(b_k, b_p, 1e-6, 1e-4) and errs["p99"] < SAMPLES_P99
          and errs["max_abs_err"] < SAMPLES_MAX
          and errs["ray_mean_err"] < SAMPLES_RAY_MEAN)
    return errs, ok


def k2_sass(resources) -> dict | None:
    """K2's instances on the main path's rounds (S = 128 and 256: E <= 2;
    S = 352 to 480: E <= 4): ptxas's and the SASS's counts."""
    if resources is None:
        return None
    rows = resources.get()
    return {w: next(v for k, v in rows.items() if w in k)
            for w in ("sampler_round_kernel<2>", "sampler_round_kernel<4>")}


def k2_inputs(model, cfg, conf, device):
    """K2's inputs in `check_kernels` (and `scripts/time_kernels.py`,
    `scripts/digest_rev.py`): the widest set (all 480 samples) of the eval
    chunk's R rays of view 0, depths sorted uniform draws (seed SEED);
    the SDF along them of two scenes, K1's of the model (`mlp`) and a wall
    at depth 3 (`wall`: what rays of a trained room see, opaque from the
    surface to the far end); beta_init of round 0's spacing and beta0.
    Returns (zs (R, S), {scene: sdf (R, S)}, beta_init (R,), beta0)."""
    sc = cfg.sampler
    R = conf.train.split_n_pixels
    _, dirs, cam = chunk_rays(conf, device, R)
    gen = torch.Generator().manual_seed(SEED)
    wk = renderer.KernelWeights.pack(model)
    S = sum(sc.eval_counts)
    zs = torch.sort(torch.rand((R, S), generator=gen) * sc.far, -1).values
    zs = zs.to(device).contiguous()
    pts2 = (cam[:, None] + zs[..., None] * dirs[:, None]).reshape(-1, 3)
    sdf_mlp_vals = sdf_mlp.sdf_mlp_nograd(wk.sdf, pts2.contiguous())
    noise = 0.1 * torch.randn((R, S), generator=gen).to(device)
    sdf_sets = {"mlp": sdf_mlp_vals.reshape(R, S),
                "wall": (3.0 - zs + noise).contiguous()}
    z0 = torch.linspace(0.0, sc.far, sc.eval_counts[0], device=device)
    dz = z0[1:] - z0[:-1]
    beta_init = torch.sqrt((1.0 / (4.0 * math.log(sc.eps + 1.0)))
                           * (dz ** 2).sum()).expand(R).contiguous()
    beta0 = effective_beta(model.beta.detach(), cfg.beta_min)
    return zs, sdf_sets, beta_init, beta0


def check_kernels(model, cfg, conf, device, k2_res=None) -> list[dict]:
    sc = cfg.sampler
    rows = []

    # K1: round 0 of the sampler
    rows.append(check_k1(model, cfg, k1_points(cfg, conf, device)))

    # K2: a refinement and the final round on `k2_inputs`
    zs, sdf_sets, beta_init, beta0 = k2_inputs(model, cfg, conf, device)
    R, S = zs.shape
    for (scene, sdf2), (final, n_out) in itertools.product(
            sdf_sets.items(),
            ((False, sc.eval_counts[-1]), (True, sc.N_samples))):
        u = torch.linspace(0, 1, n_out, device=device).expand(R, n_out)
        u = u.contiguous()
        args = (sc, zs, sdf2, beta_init, beta0, u, final)
        got = sampler_round.sampler_round(*args)
        torch.cuda.synchronize()
        errs, ok = k2_errors(got, sampler_round.sampler_round_plain(*args))
        # the training step's shape: K4_RAYS rays a round
        Rt = K4_RAYS
        args_t = (sc, zs[:Rt].contiguous(), sdf2[:Rt].contiguous(),
                  beta_init[:Rt].contiguous(), beta0, u[:Rt].contiguous(),
                  final)
        got = sampler_round.sampler_round(*args_t)
        torch.cuda.synchronize()
        errs_t, ok_t = k2_errors(
            got, sampler_round.sampler_round_plain(*args_t))
        evals = sc.beta_iters + 2
        b_ms, b_by = bound_f32(
            R * S * SAMPLER_OPS_PER_SAMPLE_EVAL * evals,
            R * S * EXP_PER_SAMPLE_EVAL * evals,
            4 * R * (2 * S + 2 * n_out + 2))
        kern = lambda: sampler_round.sampler_round(*args)  # noqa: E731
        kern_t = lambda: sampler_round.sampler_round(*args_t)  # noqa: E731
        rows.append(dict(
            name="sampler_round", route="cuda",
            source="i2sdf_tpu_torch/csrc/sampler_round.cu",
            replaces="i2sdf_tpu/ops/pallas/sampler_round.py:218",
            sdf=scene, final=final, shape=[R, S, n_out], **errs,
            train_shape=[Rt, S, n_out], train_shape_errs=errs_t,
            ms=time_ms(kern, 10),
            device_ms=device_ms(kern, 10, "sampler_round_kernel"),
            ms_train_shape=time_ms(kern_t, 20),
            device_ms_train_shape=device_ms(kern_t, 20,
                                            "sampler_round_kernel"),
            bound_ms_train_shape=b_ms * Rt / R,
            exp_per_sample_eval=EXP_PER_SAMPLE_EVAL, sfu_per_s=sfu_rate(),
            sass=k2_sass(k2_res),
            plain_ms=time_ms(
                lambda: sampler_round.sampler_round_plain(*args), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        emit_row(rows[-1], ok and ok_t)

    rows.append(check_k3(model, cfg, conf, device))
    return rows


def bf16w_sdf(net, pts):
    """K1's plain version at the net's weights rounded to bf16 (f32 biases
    and arithmetic), chunked."""
    ws = [w.float() for w in _bf16_weights(net)[0]]
    bs = [lin.b.detach().float() for lin in net.layers()]
    apply = lambda c: mlp.implicit_apply(net.cfg, ws, bs, c)[:, :1]
    with torch.no_grad():
        return torch.cat([mlp.clamp_sdf(net.cfg, apply(c), c)[:, 0]
                          for c in pts.split(1 << 18)])


def check_k1(model, cfg, pts) -> dict:
    """K1 at the sampler's first round (`pts`), at the init's weights and
    at perturbed weights (`perturbed_net`), against the f32 plain version
    (the JAX package's own K1 stays inside that bound at these perturbed
    weights: `scripts/witness_perturbed.py`), the plain version at the
    weights rounded to bf16 reported beside it (`vs_bf16w`); and the first
    n of the points for each n in EDGE_COUNTS (both sides of the block
    edges), at both weights. Timed at the init's weights."""
    nets = {"init": model.implicit,
            "perturbed": perturbed_net(model.implicit, SEED + 10)}
    fields, ok = {}, True
    for label, net in nets.items():
        pack = sdf_mlp.SdfMlpPack(net)
        got = sdf_mlp.sdf_mlp_nograd(pack, pts)
        torch.cuda.synchronize()
        f32 = ref = sdf_mlp.sdf_mlp_plain(net, pts)
        bfw = bf16w_sdf(net, pts)
        ok = ok and close(got, ref, 0.02, 0.02)
        edges = {}
        for n in EDGE_COUNTS:
            g = sdf_mlp.sdf_mlp_nograd(pack, pts[:n].contiguous())
            torch.cuda.synchronize()
            edges[n] = float((g - ref[:n]).abs().max())
            ok = ok and close(g, ref[:n], 0.02, 0.02)
        fields[label] = dict(max_abs_err=float((got - ref).abs().max()),
                             vs_bf16w=float((got - bfw).abs().max()),
                             points_past_f32=int(((got - f32).abs() > 0.02
                                                  + 0.02 * f32.abs()).sum()),
                             edges=edges)
    iw, ib = _bf16_weights(model.implicit)
    macs = hidden_macs(cfg.implicit) + cfg.implicit.layer_dims()[-2]
    wbytes = sum(w.numel() for w in iw) * 2
    b_ms, b_by = bound(2.0 * macs * len(pts), len(pts) * 16 + wbytes,
                       PEAK_BF16)
    pack = sdf_mlp.SdfMlpPack(model.implicit)
    stages = sdf_mlp.stage_chain(model.implicit)
    row = dict(
        name="sdf_mlp_nograd", route="cuda",
        source="i2sdf_tpu_torch/csrc/sdf_mlp.cu",
        replaces="i2sdf_tpu/ops/pallas/fused_mlp.py:157",
        shape=list(pts.shape), max_abs_err=fields["init"]["max_abs_err"],
        atol=0.02, rtol=0.02, **fields,
        l2_weight_gb_model=math.ceil(len(pts) / K1_POINTS)
        * stages.weights.numel() * 2 / 1e9,
        ms=time_ms(lambda: sdf_mlp.sdf_mlp_nograd(pack, pts), 10),
        plain_ms=time_ms(lambda: sdf_mlp.sdf_mlp_plain(model.implicit, pts),
                         2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: library_sdf(model.implicit, iw, ib, pts),
                           5))
    emit_row(row, ok)
    return row


def light_macs(lcfg) -> list:
    """Multiply-adds per point of each light layer at its real width."""
    d = lcfg.layer_dims()
    return [d[l] * d[l + 1] for l in range(len(d) - 1)]


def eval_chunk_points(cfg, conf, device):
    """One eval chunk's render points: 12000 rays of view 0 at the final
    sample count, evenly spaced, and their directions."""
    sc = cfg.sampler
    R = conf.train.split_n_pixels
    _, dirs, cam = chunk_rays(conf, device, R)
    S3 = sc.total_fg_samples - 1
    z3 = torch.linspace(0.0, sc.far, S3, device=device)
    x = (cam[:, None] + z3[None, :, None] * dirs[:, None]).reshape(-1, 3)
    dd = dirs[:, None].expand(R, S3, 3).reshape(-1, 3)
    return x.contiguous(), dd.contiguous()


def core_plain(nets, x, dd, bf16w: bool = False):
    """K3's plain version over (implicit, rendering, light or None), with
    `bf16w` at the nets' weights rounded to bf16 (f32 biases and
    arithmetic), chunked, sphere-clamped."""
    if not bf16w:
        return render_core.render_core_plain(*nets[:2], x, dd, nets[2])
    inet, rnet, lnet = nets
    w = render_core.CoreWeights.of(inet, rnet, lnet)
    rnd = lambda ts: tuple(t.detach().to(torch.bfloat16).float()  # noqa
                           for t in ts)
    w = render_core.CoreWeights(rnd(w.ws_sdf), w.bs_sdf, rnd(w.ws_rad),
                                w.bs_rad, rnd(w.ws_l), w.bs_l)
    outs = []
    for xc, dc in zip(x.split(1 << 16), dd.split(1 << 16)):
        sdf, grad, *rest = render_core.render_core_train_plain(
            inet.cfg, rnet.cfg, w, xc, dc,
            None if lnet is None else lnet.cfg)
        sdf, grad = render_core._sphere_clamp(inet.cfg, xc, sdf, grad)
        outs.append([t.detach() for t in (sdf, grad, *rest)])
    return [torch.cat(o) for o in zip(*outs)]


def k3_design_macs(cfg, light: bool) -> int:
    """Multiply-adds a point of K3's tangent form at the nets' real widths:
    four streams through the hidden layers, the features on the primal
    row, the sdf column on all four, the radiance net (and the light net)
    on the primal row. Not counted: the t_x rows that ride along in the
    radiance and light products' m64 tiles."""
    dims = cfg.implicit.layer_dims()
    rdims = cfg.rendering.layer_dims()
    macs = (4 * hidden_macs(cfg.implicit) + dims[-2] * (dims[-1] - 1)
            + 4 * dims[-2]
            + sum(rdims[l] * rdims[l + 1] for l in range(len(rdims) - 1)))
    if light:
        macs += sum(light_macs(cfg.light))
    return macs


def check_k3(model, cfg, conf, device) -> dict:
    """K3 (with the light head, if the model has one: its own kernel,
    `render_core_fwd_light`) on one eval chunk: at the init's weights
    against the f32 plain version (CORE_TOLS); at perturbed weights
    (`perturbed_net` of each net) and on `odd_nets` (perturbed, one SDF
    hidden layer fewer) against the plain version at the weights rounded
    to bf16, the f32 reading and the points past the bound against f32
    (`points_past_f32`) reported beside it; and the first n of the points
    for each n in EDGE_COUNTS, at every weight. Timed at the init's
    weights."""
    x, dd = eval_chunk_points(cfg, conf, device)
    nets0 = (model.implicit, model.rendering, model.light)
    nets = {"init": nets0,
            "perturbed": tuple(
                None if m is None else perturbed_net(m, SEED + 10 + i)
                for i, m in enumerate(nets0)),
            "odd": odd_nets(cfg, device, SEED + 20)}
    fields, ok = {}, True
    for label, ns in nets.items():
        pack = render_core.RenderCorePack(*ns)
        k_out = render_core.render_core_fwd(pack, x, dd)
        torch.cuda.synchronize()
        f32 = core_plain(ns, x, dd)
        ref = f32 if label == "init" else core_plain(ns, x, dd, bf16w=True)
        tols = {k: CORE_TOLS[k] for k in list(CORE_TOLS)[:len(k_out)]}
        ok = ok and all(close(a, b, *tols[k])
                        for k, a, b in zip(tols, k_out, ref))
        edges = {}
        for n in EDGE_COUNTS:
            e_out = render_core.render_core_fwd(pack, x[:n].contiguous(),
                                                dd[:n].contiguous())
            torch.cuda.synchronize()
            edges[n] = max(float((a - b[:n]).abs().max())
                           for a, b in zip(e_out, ref))
            ok = ok and all(close(a, b[:n], *tols[k])
                            for k, a, b in zip(tols, e_out, ref))
        fields[label] = dict(
            errs={k: float((a - b).abs().max())
                  for k, a, b in zip(tols, k_out, ref)},
            vs_f32={k: float((a - b).abs().max())
                    for k, a, b in zip(tols, k_out, f32)},
            points_past_f32={k: int(((a - b).abs() > tols[k][0] + tols[k][1]
                                     * b.abs()).reshape(len(a), -1).any(-1)
                                    .sum())
                             for k, a, b in zip(tols, k_out, f32)},
            edges=edges)
        del k_out, ref, f32
    light = model.light
    iw, ib = _bf16_weights(model.implicit)
    rw, rb = _bf16_weights(model.rendering)
    lw, lb = _bf16_weights(light) if light is not None else (None, None)
    dims = cfg.implicit.layer_dims()
    rdims = cfg.rendering.layer_dims()
    # the function's least work: the forward (full head), the reverse
    # sweep (the hidden layers transposed), the radiance net, the light net
    macs = (2 * hidden_macs(cfg.implicit) + dims[-2] * dims[-1]
            + sum(rdims[l] * rdims[l + 1] for l in range(len(rdims) - 1)))
    wbytes = (sum(w.numel() for w in iw) * 2 * 2
              + sum(w.numel() for w in rw) * 2)
    out_bytes = 28
    if light is not None:
        macs += sum(light_macs(cfg.light))
        wbytes += sum(w.numel() for w in lw) * 2
        out_bytes += 4
    b_ms, b_by = bound(2.0 * macs * len(x), len(x) * (24 + out_bytes)
                       + wbytes, PEAK_BF16)
    wk = render_core.RenderCorePack(*nets0)
    stages = render_core.CoreStages(
        cfg.implicit, cfg.rendering, render_core.CoreWeights.of(*nets0),
        None if light is None else light.cfg)
    block_bytes = 2 * sum(c.weights.numel() for c in
                          (stages.sdf, stages.rad, stages.light)
                          if c is not None)
    row = dict(
        name="render_core_fwd" + ("_light" if light is not None else ""),
        route="cuda", source="i2sdf_tpu_torch/csrc/render_core.cu",
        replaces="i2sdf_tpu/ops/pallas/fused_train.py:449",
        shape=list(x.shape), max_abs_err=max(fields["init"]["errs"].values()),
        errs=fields["init"]["errs"], tolerances=CORE_TOLS,
        perturbed=fields["perturbed"], odd=fields["odd"],
        edges=fields["init"]["edges"],
        macs=macs, design_macs=k3_design_macs(cfg, light is not None),
        l2_weight_gb_model=math.ceil(len(x) / K3_POINTS) * block_bytes
        / 1e9,
        ms=time_ms(lambda: render_core.render_core_fwd(wk, x, dd), 5),
        plain_ms=time_ms(lambda: render_core.render_core_plain(
            model.implicit, model.rendering, x, dd, light), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: library_render_core(
            model.implicit, iw, ib, model.rendering, rw, rb, x, dd, lw, lb),
            3))
    if light is not None:
        # the same nets without the head: what the head costs K3
        bare = render_core.RenderCorePack(model.implicit, model.rendering)
        row["ms_without_head"] = time_ms(
            lambda: render_core.render_core_fwd(bare, x, dd), 5)
    emit_row(row, ok)
    return row


def emit_row(row: dict, ok: bool) -> None:
    print(json.dumps({"phase": "kernel", "ok": ok, **row}), flush=True)
    if not ok:
        raise AssertionError(f"{row['name']}: kernel disagrees with its "
                             f"plain version")


def run_slice(model, conf, device, want=EVAL_KERNELS, never=()) -> dict:
    """One view through the eval entry point: finite outputs, every
    kernel in `want` launched (K3 with or without the light head, never
    the other) and none in `never`."""
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
    missing = [k for k in want if launches[k] == 0]
    assert not missing, f"kernels not launched on the eval path: {missing}"
    other = ("render_core_fwd" if "render_core_fwd_light" in want
             else "render_core_fwd_light")
    assert launches[other] == 0, launches
    assert all(launches[k] == 0 for k in never), launches
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
    assert set(k) == set(p)
    diff = {}
    for key, name in (("rgb_values", "rgb"), ("depth_values", "depth"),
                      ("normal_map", "normal"), ("light_mask", "light")):
        if key in k:
            d = (k[key] - p[key]).abs()
            diff[name] = {"mean_abs": float(d.mean()),
                          "max_abs": float(d.max())}
    psnr = {}
    for key in ("rgb_values", "light_mask"):
        if key in k:
            mse = float(((k[key] - p[key]) ** 2).mean())
            psnr[key] = -10 * math.log10(max(mse, 1e-20))
            assert psnr[key] >= SLICE_PSNR_BAR_DB, \
                f"kernel vs plain {key} {psnr[key]:.2f} dB"
    return dict(diff=diff, psnr_db=psnr["rgb_values"],
                light_mask_psnr_db=psnr.get("light_mask"),
                bar_db=SLICE_PSNR_BAR_DB)


# ---- K4 and the training path -----------------------------------------------

def loss_cotangents(sdf, grad, rgb, n_eik, seed, lmask=None):
    """Cotangents (N, 8) [grad | sdf | rgb | lmask] of the JAX package's
    kernel-test loss (tests/test_pallas_train.py:38-43: rgb L1, sdf^2,
    normal L1 and eikonal against seeded targets; with a light mask its
    light test's 0.3 * mean((lmask - target)^2), `:186-188`) at these
    outputs; the last n_eik rows (eikonal points) keep only the gradient's
    cotangent."""
    gen = torch.Generator().manual_seed(seed)
    n = sdf.shape[0]
    gt = torch.rand((n, 3), generator=gen).to(sdf.device)
    gn = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                       dim=-1).to(sdf.device)
    gl = torch.rand((n, 1), generator=gen).to(sdf.device)
    s, g, r = (t.detach().requires_grad_(True) for t in (sdf, grad, rgb))
    m = (sdf.new_zeros((n, 1)) if lmask is None else lmask.detach()
         ).requires_grad_(True)
    with torch.enable_grad():
        nrm = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                              min=1e-9)
        loss = ((r - gt).abs().mean() + 0.2 * (s ** 2).mean()
                + 0.5 * (1 - (nrm * gn).sum(-1)).abs().mean()
                + 0.1 * ((torch.linalg.norm(g, dim=-1) - 1) ** 2).mean()
                + 0.3 * ((m - gl) ** 2).mean() * (lmask is not None))
        cs, cg, cr, cm = torch.autograd.grad(loss, (s, g, r, m))
    cot = torch.cat([cg, cs, cr, cm], 1)
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


def k4_macs(icfg, rcfg, lcfg=None, detach_light=True) -> int:
    """Multiply-adds per point of K4 at the nets' real widths: forward
    recompute (SDF, full head, and radiance), reverse sweep (hidden layers
    1 .. n-2 transposed), radiance backward (every layer transposed),
    upward sweep (layers 0 .. n-2), downward sweep (layers n-1 .. 1), and
    the weight-gradient products (two per SDF layer, one per radiance
    layer). With a light head: its forward, its backward through layers
    n_l-1 .. 1 transposed (and layer 0 unless detached), and one
    weight-gradient product per light layer."""
    sd = sdf_layer_macs(icfg)
    n = len(sd)
    rd = rcfg.layer_dims()
    rr = [rd[l] * rd[l + 1] for l in range(len(rd) - 1)]
    macs = (sum(sd) + sum(rr) + sum(sd[1:n - 1]) + sum(rr)
            + sum(sd[:n - 1]) + sum(sd[1:]) + 2 * sum(sd) + sum(rr))
    if lcfg is not None:
        lm = light_macs(lcfg)
        macs += (sum(lm) + sum(lm[1:]) + (0 if detach_light else lm[0])
                 + sum(lm))
    return macs


def library_core_grad(icfg, rcfg, w, x, dirs, cot, lcfg=None,
                      detach_light=True):
    """The same function as one PyTorch call chain: autograd of the plain
    op with every product a bf16 torch.matmul (autocast)."""
    with torch.autocast("cuda", dtype=torch.bfloat16):
        outs = render_core.render_core_train_plain(icfg, rcfg, w, x, dirs,
                                                   lcfg, detach_light)
    cots = (cot[:, 3:4], cot[:, :3], cot[:, 4:7], cot[:, 7:8])
    return torch.autograd.grad(outs, w.flat(), cots[:len(outs)])


def odd_nets(cfg, device, seed):
    """The model's nets with one SDF hidden layer fewer (an odd count for
    the flagship's eight and the light config's six), perturbed like
    `perturbed_net` from a seeded init: a fault that exchanges two tangent
    streams at every layer cancels over an even depth."""
    icfg = dataclasses.replace(cfg.implicit,
                               dims=cfg.implicit.dims[:-1])
    gen = torch.Generator().manual_seed(seed)
    nets = [mlp.ImplicitNet(icfg, gen), mlp.RenderingNet(cfg.rendering, gen)]
    if cfg.light is not None:
        nets.append(mlp.ImplicitNet(cfg.light, gen))
    nets = [perturbed_net(m.to(device), seed + 1 + i)
            for i, m in enumerate(nets)]
    return tuple(nets) + (None,) * (3 - len(nets))


def k4_batch(cfg, conf, device):
    """K4's points: one training step's render-core batch, 1600 rays of
    view 0 at 97 depths each plus 4800 eikonal rows in the scene's cube."""
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
    return x, d, S


def k4_grads(nets, x, d, detach_light):
    """K4 and the plain f32 backward of the nets (implicit, rendering,
    light or None) at the cotangents of a seeded loss: (kernel leaves,
    plain leaves, cotangents, weights, packs)."""
    inet, rnet, lnet = nets
    icfg, rcfg = inet.cfg, rnet.cfg
    lcfg = None if lnet is None else lnet.cfg
    w = render_core.CoreWeights.of(inet, rnet, lnet)
    outs = render_core.render_core_train_plain(icfg, rcfg, w, x, d, lcfg,
                                               detach_light)
    cot = loss_cotangents(*outs[:3], K4_EIK, SEED + 5,
                          lmask=outs[3] if lcfg is not None else None)
    cots = (cot[:, 3:4], cot[:, :3], cot[:, 4:7], cot[:, 7:8])[:len(outs)]
    ref = torch.autograd.grad(outs, w.flat(), cots)
    del outs
    with torch.no_grad():
        packs = (render_core.CoreStages(icfg, rcfg, w, lcfg),
                 render_core.K4Stages(icfg, rcfg, w, lcfg))
        got = render_core.render_core_bwd(*packs, x, d, cot, detach_light)
    torch.cuda.synchronize()
    return [t for grp in got for t in grp], list(ref), cot, w, packs


def k4_staging_gb(plan) -> float:
    """The device memory (GB) K4's plan (or K9's) takes beside its
    output: the scratch (operand and stash regions, bias rows) and the
    partials."""
    return (plan.scratch_bytes + 4 * plan.n32) / 1e9


class Resources:
    """`scripts/kernel_resources.py` on some sources, started at once in the
    background (it compiles the sources again with `-Xptxas -v`); `get()`
    waits for it and returns its rows by kernel name."""

    def __init__(self, *sources: str):
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / "kernel_resources.py"),
             *(str(ROOT / src) for src in sources)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.rows = None

    def get(self) -> dict:
        if self.rows is None:
            out, err = self.proc.communicate(timeout=600)
            if self.proc.returncode != 0:
                raise RuntimeError(f"kernel_resources failed: {err[-2000:]}")
            self.rows = {}
            for line in out.splitlines():
                row = json.loads(line)
                self.rows[row["name"]] = {
                    k: row[k] for k in ("registers", "spill_stores",
                                        "spill_loads", "stack", "hgmma",
                                        "bulk_copies", "bulk_ops",
                                        "warnings")}
        return self.rows


def k4_sass(resources: Resources, light: bool, coupled: bool) -> dict:
    """K4's kernels' ptxas and SASS counts: its sweep (with the light head
    or not, coupled or not) and its products."""
    rows = resources.get()
    want = (f"k4_sweep_kernel<{str(light).lower()}, {str(coupled).lower()}>",
            "wgrad_kernel<4>")
    return {w: next(v for k, v in rows.items() if w in k) for w in want}


def check_k4(model, cfg, conf, device, detach_light=True,
             resources: Resources | None = None) -> dict:
    """K4 at one training step's render-core batch (`k4_batch`) with the
    model's light head if it has one (its own kernel,
    `render_core_bwd_light`, at this `detach_light`): against the plain f32
    backward (`grads_ok`) at the init's weights, at perturbed weights
    (`perturbed_net`) and on `odd_nets`; two launches give the same bits.
    Timed at the init's weights."""
    x, d, S = k4_batch(cfg, conf, device)
    icfg, rcfg, lcfg = cfg.implicit, cfg.rendering, cfg.light
    nets0 = (model.implicit, model.rendering, model.light)
    cases = {"init": nets0,
             "perturbed": tuple(None if m is None else
                                perturbed_net(m, SEED + 10 + i)
                                for i, m in enumerate(nets0)),
             "odd": odd_nets(cfg, device, SEED + 20)}
    fields, ok = {}, True
    for label, nets in cases.items():
        got, ref, cot, w, packs = k4_grads(nets, x, d, detach_light)
        errs = grad_errors(got, ref)
        ok = ok and grads_ok(errs)
        fields[label] = errs
        if label == "init":
            w0, cot0, packs0 = w, cot, packs
            again = render_core.render_core_bwd(*packs, x, d, cot,
                                                detach_light)
            same = all(torch.equal(a, b) for a, b in zip(
                got, [t for grp in again for t in grp]))
            ok = ok and same
            max_abs = max(float((g - r).abs().max())
                          for g, r in zip(got, ref))
        del got, ref
    n = x.shape[0]
    wbytes = sum(t.numel() for t in w0.flat())
    b_ms, b_by = bound(2.0 * k4_macs(icfg, rcfg, lcfg, detach_light) * n,
                       n * (24 + 4 * cot0.shape[1]) + wbytes * (2 + 4),
                       PEAK_BF16)
    cots = (cot0[:, 3:4], cot0[:, :3], cot0[:, 4:7], cot0[:, 7:8])

    def kernel():
        with torch.no_grad():
            render_core.render_core_bwd(*packs0, x, d, cot0, detach_light)

    def plain():
        outs = render_core.render_core_train_plain(icfg, rcfg, w0, x, d,
                                                   lcfg, detach_light)
        torch.autograd.grad(outs, w0.flat(), cots[:len(outs)])

    plan = render_core.plan_for(*packs0, n, lcfg is not None
                                and not detach_light)
    row = dict(
        name="render_core_bwd" + ("_light" if lcfg is not None else ""),
        route="cuda", source="i2sdf_tpu_torch/csrc/render_core_bwd.cu",
        replaces="i2sdf_tpu/ops/pallas/fused_train.py:449",
        shape=list(cot0.shape), rays=K4_RAYS, samples=S,
        eikonal_rows=K4_EIK,
        detach_light=detach_light if lcfg is not None else None,
        max_abs_err=max_abs, **fields["init"],
        perturbed=fields["perturbed"], odd=fields["odd"], bitwise_rerun=same,
        leaf_tol=GRAD_LEAF_TOL, cos_tol=GRAD_COS_TOL,
        staging_gb=k4_staging_gb(plan),
        sass=(k4_sass(resources, lcfg is not None,
                      lcfg is not None and not detach_light)
              if resources is not None else None),
        ms=time_ms(kernel, 5), plain_ms=time_ms(plain, 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: library_core_grad(
            icfg, rcfg, w0, x, d, cot0, lcfg, detach_light), 2))
    if lcfg is not None:
        # the same nets without the head (it ignores cotangent column 7):
        # what the head costs K4
        with torch.no_grad():
            w1 = render_core.CoreWeights.of(model.implicit, model.rendering)
            bare = (render_core.CoreStages(icfg, rcfg, w1),
                    render_core.K4Stages(icfg, rcfg, w1))
        row["ms_without_head"] = time_ms(
            lambda: render_core.render_core_bwd(*bare, x, d, cot0), 5)
    emit_row(row, ok)
    return row


# ---- K5 and K6: get_rev_op's forward and backward ---------------------------

def k5_macs(icfg) -> int:
    """K5 per point: the forward with the full head, and the reverse sweep
    through the transposed layers n-2 .. 0."""
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


# K6's kernels in a profile: its sweep, its products, the fixed-order sums
K6_KERNELS = ("k6_sweep_kernel", "wgrad_kernel<6>", "sum_kernel")


def flat(groups) -> list:
    return [t for g in groups for t in g]


def rev_nets(model, cfg, device) -> dict:
    """K6's nets: the model's SDF net at the init, perturbed
    (`perturbed_net`, seed SEED + 10) and of odd depth (`odd_nets`)."""
    return {"init": model.implicit,
            "perturbed": perturbed_net(model.implicit, SEED + 10),
            "odd": odd_nets(cfg, device, SEED + 20)[0]}


def k6_sass(resources) -> dict | None:
    """K6's kernels' ptxas and SASS counts: its sweep and its products."""
    if resources is None:
        return None
    rows = resources.get()
    return {w: next(v for k, v in rows.items() if w in k)
            for w in ("k6_sweep_kernel", "wgrad_kernel<6>")}


def rev_errors(got, ref) -> tuple[dict, bool]:
    """K5's (out, grad) against a reference: each part's max error, the
    points with an entry past `REV_TOLS` (`past`), and whether there are
    none."""
    pairs = {"sdf": (got[0][:, :1], ref[0][:, :1]),
             "feat": (got[0][:, 1:], ref[0][:, 1:]),
             "grad": (got[1], ref[1])}
    errs = {name: float((a - b.detach()).abs().max())
            for name, (a, b) in pairs.items()}
    bad = torch.zeros_like(got[1][:, 0], dtype=torch.bool)
    for name, (a, b) in pairs.items():
        atol, rtol = REV_TOLS[name]
        b = b.detach()
        bad |= ((a - b).abs() > atol + rtol * b.abs()).any(-1)
    errs["past"] = int(bad.sum())
    return errs, errs["past"] == 0


def replay_gaps(got, rep) -> dict:
    """K5's (out, grad) against its replay: for each of REPLAY_GAPS the
    points with an entry (sdf, features or gradient) further than that
    from the replay's."""
    gap = torch.cat([(got[0] - rep[0]).abs(), (got[1] - rep[1]).abs()],
                    -1).amax(-1)
    return {str(t): int((gap > t).sum()) for t in REPLAY_GAPS}


def replay_ok(gaps: dict, n: int) -> bool:
    """`replay_gaps`' counts at n points within REPLAY_GATE."""
    return all(gaps[str(t)] <= math.ceil(share * n)
               for t, share in REPLAY_GATE)


def k5_sass(resources) -> dict | None:
    """K5's kernel's ptxas and SASS counts."""
    if resources is None:
        return None
    rows = resources.get()
    return {"k5_sweep_kernel": next(v for k, v in rows.items()
                                    if "k5_sweep_kernel" in k)}


def check_rev(model, cfg, conf, device, resources=None) -> list[dict]:
    """K5 and K6 at the normal-off step's eikonal batch (4,800 points) and
    at 155,200 points, both on one pack (`rev.RevStages`), against the
    plain op (`rev_plain`: f32 autograd with create_graph), at the model's
    SDF net at the init, at the perturbed net (`perturbed_net`, seed
    SEED + 10) and on the odd-depth net (`odd_nets`: seven hidden layers).
    K5 (K6's wgmma forward and reverse sweep) against `REV_TOLS` (at the
    init on f32; at the perturbed and odd nets at the weights rounded to
    bf16, as K3: the JAX package's own rev forward is past the f32 bound at
    6 and 4 of the 155,200 points at the perturbed and odd-depth nets,
    none against bf16 weights, `scripts/witness_perturbed.py rev`; the f32
    reading reported, `vs_f32`) and against its bf16 replay
    (`replay.K5Replay`, run on the card's tensors) at the same bounds and
    at `REPLAY_GATE` (`replay_ok`); K6 (K4's wgmma sweeps) against the
    f32 plain backward (the JAX rev backward stays inside that bound at the
    perturbed net) and its bf16 replay (`replay.RevReplay`) at `grads_ok`'s
    bounds. At the
    init a rerun of each gives the same bits; at the eikonal batch padding
    rows change no real row of K5's output, and rows with zero cotangents
    in the same blocks add nothing to K6's. Timed at the init's net."""
    icfg = cfg.implicit
    net = model.implicit
    lins = net.layers()
    ws, bs = [l.weight() for l in lins], [l.b for l in lins]
    out_cols = icfg.feature_vector_size + 1
    n_w = sum(w.numel() for w in ws)
    n_p = n_w + sum(b.numel() for b in bs)
    rows = []
    for label, x in (("eikonal", eikonal_batch(cfg, conf, device, SEED + 8)),
                     ("render", render_batch(cfg, conf, device))):
        n = x.shape[0]
        # K5
        fields, ok, packs = {}, True, {}
        nets = rev_nets(model, cfg, device)
        for case, m in nets.items():
            lm = m.layers()
            ws_, bs_ = [l.weight() for l in lm], [l.b for l in lm]
            with torch.no_grad():
                k5 = packs[case] = rev.RevStages(m.cfg, ws_, bs_)
                got = rev.rev_fwd(k5, x)
                torch.cuda.synchronize()
                rep = replay.emulate_rev_fwd(k5, x)
            ref = rev.rev_plain(m.cfg, ws_, bs_, x)
            if case == "init":
                errs, ok_p = rev_errors(got, ref)
            else:
                wb = [w.detach().to(torch.bfloat16).float() for w in ws_]
                errs, ok_p = rev_errors(got, rev.rev_plain(m.cfg, wb, bs_,
                                                           x))
                errs["vs_f32"] = rev_errors(got, ref)[0]
            rerrs, ok_r = rev_errors(got, rep)
            rerrs["past_gap"] = replay_gaps(got, rep)
            ok_r = ok_r and replay_ok(rerrs["past_gap"], n)
            del rep, ref
            ok = ok and ok_p and ok_r
            fields[case] = dict(errs, replay=rerrs)
            if case == "init":
                k50 = k5
                max_abs = max(errs[k] for k in ("sdf", "feat", "grad"))
                with torch.no_grad():
                    same = all(torch.equal(a, b) for a, b in zip(
                        got, rev.rev_fwd(k5, x)))
                    pad = None
                    if label == "eikonal":
                        # the first n - 10 rows alone: the same 75 blocks
                        m0 = n - 10
                        pad = all(torch.equal(a[:m0], b) for a, b in zip(
                            got, rev.rev_fwd(k5, x[:m0].contiguous())))
                ok = ok and same and pad is not False
            del got
        b_ms, b_by = bound(2.0 * k5_macs(icfg) * n,
                           n * (12 + 4 * out_cols + 12) + 2 * 2 * n_w,
                           PEAK_BF16)

        def k5():
            with torch.no_grad():
                rev.rev_fwd(k50, x)

        def lib5():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                rev.rev_plain(icfg, ws, bs, x)

        rows.append(dict(
            name="rev_fwd", route="cuda",
            source="i2sdf_tpu_torch/csrc/rev_fwd.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_rev.py:213",
            points=label, shape=[n, 3], max_abs_err=max_abs,
            **fields["init"], perturbed=fields["perturbed"],
            odd=fields["odd"], bitwise_rerun=same,
            padding_changes_nothing=pad, tolerances=REV_TOLS,
            staging_gb=rev.k5_plan_for(k50, n).scratch_bytes / 1e9,
            sass=k5_sass(resources),
            ms=time_ms(k5, 5),
            device_ms=device_ms(k5, 5, "k5_sweep_kernel"),
            plain_ms=time_ms(lambda: rev.rev_plain(icfg, ws, bs, x), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib5, 3)))
        emit_row(rows[-1], ok)
        # K6, on K5's packs
        fields, ok = {}, True
        for case, m in nets.items():
            lm = m.layers()
            ws_, bs_ = [l.weight() for l in lm], [l.b for l in lm]
            out_p, grad_p = rev.rev_plain(m.cfg, ws_, bs_, x)
            c_out, c_g = rev_cotangents(out_p, grad_p, SEED + 9)
            ref = torch.autograd.grad((out_p, grad_p), ws_ + bs_,
                                      (c_out, c_g))
            del out_p, grad_p
            with torch.no_grad():
                k6 = packs[case]
                got = flat(rev.rev_bwd(k6, x, c_out, c_g))
                torch.cuda.synchronize()
                rep = flat(replay.emulate_rev_bwd(k6, x, c_out, c_g))
            errs, rerrs = grad_errors(got, ref), grad_errors(got, rep)
            del rep
            ok = ok and grads_ok(errs) and grads_ok(rerrs)
            fields[case] = dict(errs, replay=rerrs)
            if case == "init":
                k60, c_out0, c_g0 = k6, c_out, c_g
                max_abs = max(float((g - r).abs().max())
                              for g, r in zip(got, ref))
                with torch.no_grad():
                    same = all(torch.equal(a, b) for a, b in zip(
                        got, flat(rev.rev_bwd(k6, x, c_out, c_g))))
                    pad = None
                    if label == "eikonal":
                        # the last 10 rows' cotangents zeroed: the same
                        # 75 blocks as the first n - 10 rows alone
                        m0 = n - 10
                        cz, gz = c_out.clone(), c_g.clone()
                        cz[m0:], gz[m0:] = 0.0, 0.0
                        pad = all(torch.equal(a, b) for a, b in zip(
                            flat(rev.rev_bwd(k6, x, cz, gz)),
                            flat(rev.rev_bwd(k6, x[:m0].contiguous(),
                                             c_out[:m0].contiguous(),
                                             c_g[:m0].contiguous()))))
                ok = ok and same and pad is not False
            del ref, got
        b_ms, b_by = bound(2.0 * k6_macs(icfg) * n,
                           n * (12 + 4 * out_cols + 12) + 2 * 2 * n_w
                           + 4 * n_p, PEAK_BF16)

        def k6():
            with torch.no_grad():
                rev.rev_bwd(k60, x, c_out0, c_g0)

        def plain6():
            torch.autograd.grad(rev.rev_plain(icfg, ws, bs, x), ws + bs,
                                (c_out0, c_g0))

        def lib6():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                outs = rev.rev_plain(icfg, ws, bs, x)
            torch.autograd.grad(outs, ws + bs, (c_out0, c_g0))

        rows.append(dict(
            name="rev_bwd", route="cuda",
            source="i2sdf_tpu_torch/csrc/rev_bwd.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_rev.py:213",
            points=label, shape=[n, 3], cotangents=[out_cols, 3],
            staging_gb=k4_staging_gb(rev.plan_for(k60, n)),
            max_abs_err=max_abs, **fields["init"],
            perturbed=fields["perturbed"], odd=fields["odd"],
            bitwise_rerun=same, padding_adds_nothing=pad,
            leaf_tol=GRAD_LEAF_TOL, cos_tol=GRAD_COS_TOL,
            sass=k6_sass(resources),
            ms=time_ms(k6, 5), device_ms=device_ms(k6, 5, K6_KERNELS),
            plain_ms=time_ms(plain6, 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib6, 2)))
        emit_row(rows[-1], ok)
        del c_out0, c_g0
        torch.cuda.empty_cache()
    return rows


# ---- K10-K12: the tangent-stream ops (fused_outputs.py, fused_grad.py) -----

def tangent_design_macs(icfg) -> int:
    """Multiply-adds a point of the tangent form (K10's and K11's design):
    four streams through the hidden layers, the features on the primal
    row, the sdf column on all four (K10's t_x rows that ride along in
    the features' m64 tile not counted, as in K3's `k3_design_macs`)."""
    d = icfg.layer_dims()
    return 4 * hidden_macs(icfg) + d[-2] * (d[-1] - 1) + 4 * d[-2]


def perturbed_net(net, seed):
    """A copy of the net with every parameter moved by 0.01 N(0, 1),
    seeded: off the init's zero encoding rows of layer 0 and the skip,
    which hide a fault in the tangents' layout."""
    net = copy.deepcopy(net)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen).to(p.device))
    return net


def net_weights(net):
    lins = net.layers()
    return [l.weight() for l in lins], [l.b for l in lins]


def tangent_faults(icfg, x) -> dict:
    """The encoding's tangents (into layer 0, at the skip) as a faulty
    K10-K12 would build them: the sin and cos blocks swapped, the skip's
    dropped, the x and y axes swapped."""
    t = sdf_grad.embed_tangents(icfg, x)
    a, b = 3, 3 + 3 * icfg.multires
    swapped = torch.cat([t[..., :a], t[..., b:], t[..., a:b]], -1)
    return {"cos_sin_swapped": (swapped, swapped),
            "skip_tangents_dropped": (t, torch.zeros_like(t)),
            "axes_permuted": (t[[1, 0, 2]], t[[1, 0, 2]])}


def sweep_outputs(net, x, clamp: bool, fault=None, bf16w: bool = False):
    """(sdf, feat, grad) of the plain tangent sweep (chunked, no gradient):
    with `fault`, that planted tangent fault; with `bf16w`, at the weights
    rounded to bf16 (the kernels' operands; f32 biases and arithmetic);
    clamped to the bounding sphere if `clamp`."""
    icfg = net.cfg
    ws, bs = net_weights(net)
    if bf16w:
        ws = [w.to(torch.bfloat16).float() for w in ws]
    outs = []
    with torch.no_grad():
        for xc in x.split(1 << 16):
            tans = tangent_faults(icfg, xc)[fault] if fault else ()
            out, grad = sdf_grad.sdf_tangents(icfg, ws, bs, xc, *tans)
            sdf = out[:, :1]
            if clamp:
                sdf, grad = render_core._sphere_clamp(icfg, xc, sdf, grad)
            outs.append((sdf, out[:, 1:], grad))
    return [torch.cat(o) for o in zip(*outs)]


def fault_vjp(net, x, c_out, c_g, fault):
    """The weight gradients of <c_out, out> + <c_g, grad> through the plain
    tangent sweep with one planted fault (chunked)."""
    icfg = net.cfg
    ws, bs = net_weights(net)
    total = None
    for xc, co, cg in zip(x.split(1 << 15), c_out.split(1 << 15),
                          c_g.split(1 << 15)):
        out, grad = sdf_grad.sdf_tangents(
            icfg, ws, bs, xc, *tangent_faults(icfg, xc)[fault])
        g = torch.autograd.grad((out, grad), ws + bs, (co, cg))
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return total


def took_sphere(icfg, x, out) -> torch.Tensor:
    """The points where (sdf, feat, grad) `out` took the bounding sphere's
    branch of the clamp: the sdf the sphere's and the gradient the
    sphere's (the sdf alone can sit within a rounding of the sphere on
    the net's branch)."""
    norm = torch.linalg.norm(x, dim=-1)
    sphere = icfg.sphere_scale * (icfg.sdf_bounding_sphere - norm)
    grad = -icfg.sphere_scale * x / torch.clamp(norm, min=1e-12)[:, None]
    return (((out[0][:, 0] - sphere).abs() < 1e-5)
            & ((out[2] - grad).abs().amax(-1) < 1e-5))


def tangent_check(got, ref, x, icfg, clamped: bool,
                  where: bool = False) -> tuple[dict, bool]:
    """(sdf, feat, grad) of a tangent kernel against the plain op's, by
    the JAX package's bounds for its tangent kernels (TAN_TOLS, and the
    gradient's cosine > TAN_COS_TOL at each point where the plain
    gradient's norm is at least TAN_COS_MIN_NORM; `cos_min_all` is over
    every point). For `clamped` outputs (K10) with a bounding sphere,
    the points where the two took different branches of the clamp
    (`took_sphere`: next to the sphere the kernel's bf16 sdf may pick the
    other) are left out; at most 1% may be. `points_past` counts the
    points past a bound; with `where`, `past_x` lists the first 64 of
    them (x, y, z and the bound each fails), so that another kernel can be
    run there."""
    agree = torch.ones_like(ref[0][:, 0], dtype=torch.bool)
    if clamped and icfg.sdf_bounding_sphere > 0:
        agree = took_sphere(icfg, x, got) == took_sphere(icfg, x, ref)
    if not bool(agree.any()):  # every point on the other branch
        return dict(errs={k: None for k in TAN_TOLS}, sphere_agree=0.0,
                    points_past=len(agree)), False
    got = [t[agree] for t in got]
    ref = [t.detach()[agree] for t in ref]
    g, gr = got[2], ref[2]
    cos = (g * gr).sum(-1) / torch.clamp(g.norm(dim=-1) * gr.norm(dim=-1),
                                         min=1e-9)
    held = gr.norm(dim=-1) >= TAN_COS_MIN_NORM
    errs = {k: float((a - b).abs().max())
            for k, a, b in zip(TAN_TOLS, got, ref)}
    past = {k: ((a - b).abs() > TAN_TOLS[k][0]
                + TAN_TOLS[k][1] * b.abs()).any(-1)
            for k, a, b in zip(TAN_TOLS, got, ref)}
    past["cos"] = held & (cos <= TAN_COS_TOL)
    any_past = torch.stack(list(past.values())).any(0)
    fields = dict(errs=errs,
                  cos_min=float(cos[held].min()) if held.any() else 1.0,
                  cos_held=float(held.float().mean()),
                  cos_min_all=float(cos.min()),
                  sphere_agree=float(agree.float().mean()),
                  points_past=int(any_past.sum()))
    if where:
        xa = x[agree]
        fields["past_x"] = [
            [*xa[i].tolist(), [k for k in past if bool(past[k][i])]]
            for i in torch.nonzero(any_past)[:64, 0].tolist()]
    ok = (all(close(a, b, *TAN_TOLS[k]) for k, a, b in zip(TAN_TOLS, got,
                                                              ref))
          and fields["cos_min"] > TAN_COS_TOL
          and fields["sphere_agree"] >= 0.99)
    return fields, ok


def k10_nets(model, cfg, device) -> dict:
    """K10's nets: the model's SDF net at the init (no bounding sphere:
    the renderer's nets take none), perturbed (`perturbed_net`, seed
    SEED + 10), and perturbed nets of odd depth: K3's (`odd_nets`, seven
    hidden layers) and one of five (the light config's odd depth; a fault
    that exchanges two tangent streams at every layer cancels over an
    even depth). The perturbed net and K3's odd one are clamped to the
    scene's bounding sphere (`scene_bounding_sphere`, radius 3: about a
    third of the eval chunk's points lie past it)."""
    icfg = dataclasses.replace(cfg.implicit, dims=cfg.implicit.dims[:5])
    gen = torch.Generator().manual_seed(SEED + 30)
    nets = {"init": model.implicit,
            "perturbed": perturbed_net(model.implicit, SEED + 10),
            "odd": odd_nets(cfg, device, SEED + 20)[0],
            "odd5": perturbed_net(mlp.ImplicitNet(icfg, gen).to(device),
                                  SEED + 31)}
    for label in ("perturbed", "odd"):  # new nets: their own configs
        nets[label].cfg = dataclasses.replace(
            nets[label].cfg, sdf_bounding_sphere=cfg.scene_bounding_sphere)
    return nets


def sphere_share(net, x, out) -> float:
    """The share of the points where the clamped (sdf, feat, grad) `out`
    took the bounding sphere (`took_sphere`; 0 without one)."""
    if net.cfg.sdf_bounding_sphere <= 0:
        return 0.0
    return float(took_sphere(net.cfg, x, out).float().mean())


def k10_sass(resources) -> dict | None:
    """K10's kernel's ptxas and SASS counts."""
    if resources is None:
        return None
    rows = resources.get()
    return {"sdf_outputs_kernel": next(v for k, v in rows.items()
                                       if "sdf_outputs_kernel" in k)}


def check_sdf_outputs(model, cfg, conf, device,
                      resources=None) -> list[dict]:
    """K10 (K3's wgmma tangent form on the SDF net, `OutputStages`) at the
    first eval chunk's 1,164,000 sample points (`eval_chunk_points`), the
    bounding sphere, where a net has one, below the net's sdf at a share
    of them and above it at the rest (both sides of the clamp;
    `sphere_share`), at the nets of `k10_nets`: against the plain op
    (`sdf_outputs_plain`, the tangent sweep in f32) at the init, and at
    the plain op at the weights rounded
    to bf16 at the perturbed and odd-depth nets, as K3 is (the JAX
    package's own K3 is past the f32 bound at 12 of these points there,
    `scripts/witness_perturbed.py`; the f32 reading is reported as
    `vs_f32`, with the points past it); against its bf16 replay
    (`replay.emulate_sdf_outputs`, on the card's tensors) at the same
    bounds and at `REPLAY_GATE`; the first n points for n in
    K10_EDGE_COUNTS, inside the same bounds and equal to the full run's
    rows bit for bit, and a rerun to the same bits; at the perturbed net
    each planted tangent fault in the plain op must fail the check. Timed
    at the init's net on its pack."""
    icfg = cfg.implicit
    x, _ = eval_chunk_points(cfg, conf, device)
    n = x.shape[0]
    fields, ok = {}, True
    for label, net in k10_nets(model, cfg, device).items():
        with torch.no_grad():
            k = sdf_outputs.OutputStages(net.cfg, *net_weights(net))
            got = sdf_outputs.sdf_outputs_fwd(k, net.cfg, x)
            torch.cuda.synchronize()
            f32 = sdf_outputs.sdf_outputs_plain(net, x)
            ref = (f32 if label == "init"
                   else sweep_outputs(net, x, True, bf16w=True))
            f, ok_p = tangent_check(got, ref, x, net.cfg, True)
            if label != "init":
                f["vs_f32"] = tangent_check(got, f32, x, net.cfg, True,
                                            True)[0]
            del f32
            # with a sphere, both sides of the clamp are taken
            f["sphere_share"] = sphere_share(net, x, ref)
            ok_p = ok_p and (0.0 < f["sphere_share"] < 1.0
                             if net.cfg.sdf_bounding_sphere > 0
                             else f["sphere_share"] == 0.0)
            rep = replay.emulate_sdf_outputs(k, net.cfg, x)
            rf, ok_r = tangent_check(got, rep, x, net.cfg, True)
            rf["past_gap"] = replay_gaps(
                (torch.cat(got[:2], 1), got[2]),
                (torch.cat(rep[:2], 1), rep[2]))
            ok_r = ok_r and replay_ok(rf["past_gap"], n)
            f["replay"] = rf
            del rep
            edges, same = {}, True
            for m in K10_EDGE_COUNTS:
                e = sdf_outputs.sdf_outputs_fwd(k, net.cfg,
                                                x[:m].contiguous())
                ef, ok_e = tangent_check(e, [t[:m] for t in ref], x[:m],
                                         net.cfg, True)
                same = same and all(torch.equal(a, b[:m])
                                    for a, b in zip(e, got))
                edges[m] = ef["errs"]
                ok_p = ok_p and ok_e
            rerun = all(torch.equal(a, b) for a, b in zip(
                got, sdf_outputs.sdf_outputs_fwd(k, net.cfg, x)))
            f.update(edges=edges, edges_bitwise=same, bitwise_rerun=rerun)
            if label == "perturbed":
                bad = {fl: tangent_check(sweep_outputs(net, x, True, fl),
                                         ref, x, net.cfg, True)
                       for fl in tangent_faults(icfg, x[:1])}
                f["fault_errs"] = {fl: v[0] for fl, v in bad.items()}
                f["faults_caught"] = not any(v[1] for v in bad.values())
                ok_p = ok_p and f["faults_caught"]
            ok = ok and ok_p and ok_r and same and rerun
            fields[label] = f
            if label == "init":
                k0 = k
            del got, ref
        torch.cuda.empty_cache()
    net = model.implicit
    ws, _ = net_weights(net)
    n_w = sum(w.numel() for w in ws)
    # the function's least work: K5's (the forward with the full head,
    # the reverse sweep through the hidden layers transposed)
    macs = k5_macs(icfg)
    b_ms, b_by = bound(2.0 * macs * n,
                       n * (12 + 4 * icfg.layer_dims()[-1] + 12) + 2 * n_w,
                       PEAK_BF16)

    def k10():
        with torch.no_grad():
            sdf_outputs.sdf_outputs_fwd(k0, icfg, x)

    def library():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            sdf_outputs.sdf_outputs_plain(net, x)

    with torch.no_grad():
        row = dict(
            name="sdf_outputs", route="cuda",
            source="i2sdf_tpu_torch/csrc/sdf_outputs.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_outputs.py:95",
            shape=[n, 3], max_abs_err=max(fields["init"]["errs"].values()),
            **fields["init"], perturbed=fields["perturbed"],
            odd=fields["odd"], odd5=fields["odd5"], tolerances=TAN_TOLS,
            cos_tol=TAN_COS_TOL, sass=k10_sass(resources), macs=macs,
            design_macs=tangent_design_macs(icfg),
            l2_weight_gb_model=math.ceil(n / K3_POINTS) * 2
            * k0.sdf.weights.numel() / 1e9,
            ms=time_ms(k10, 5),
            device_ms=device_ms(k10, 5, "sdf_outputs_kernel"),
            plain_ms=time_ms(lambda: sdf_outputs.sdf_outputs_plain(net, x),
                             2),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 2))
    emit_row(row, ok)
    return [row]


def check_sdf_grad(model, cfg, conf, device) -> list[dict]:
    """K11 and K12 at the normal-off step's eikonal batch (4,800 points)
    and at 155,200 points, at the init's weights and at perturbed weights,
    against the plain op (`sdf_grad_plain`: f32 autograd with
    create_graph), K11 at the perturbed weights against the plain sweep at
    the weights rounded to bf16 as K3 is (the f32 comparison reported as
    `vs_f32`), K12 with the cotangents of the JAX package's kernel-test
    loss (`rev_cotangents`) and with their c_g alone; at the perturbed
    weights each planted tangent fault in the plain op must fail the same
    check (K12's with c_g alone). Each row also holds
    K11 against K5 (at the perturbed weights past the bounds at no more
    points than against the f32 op: K5's layer 0 is the more exact) and
    K12, which is K6 on its own pack (`sdf_grad.bwd_stages`), against K6
    on another on the same points, weights and cotangents: bit for bit
    (`vs_rev_bwd`). Both rows' bounds count the function's least work
    (K5's and K6's), `design_macs` the design's own."""
    icfg = cfg.implicit
    rows = []
    nets = (("init", model.implicit),
            ("perturbed", perturbed_net(model.implicit, SEED + 10)))
    for (label, x), (wlabel, net) in itertools.product(
            (("eikonal", eikonal_batch(cfg, conf, device, SEED + 8)),
             ("render", render_batch(cfg, conf, device))), nets):
        n = x.shape[0]
        ws, bs = net_weights(net)
        n_w = sum(w.numel() for w in ws)
        n_p = n_w + sum(b.numel() for b in bs)
        with torch.no_grad():
            k = sdf_grad.SdfGradLayout(icfg, ws, bs)
            kr = rev.RevStages(icfg, ws, bs)
        # K11
        with torch.no_grad():
            out, grad = sdf_grad.sdf_grad_fwd(k, x)
            torch.cuda.synchronize()
            out5, grad5 = rev.rev_fwd(kr, x)
        out_p, grad_p = sdf_grad.sdf_grad_plain(icfg, ws, bs, x)
        split = lambda o, g: (o[:, :1], o[:, 1:], g)  # noqa: E731
        ref11, vs_f32 = split(out_p, grad_p), None
        if wlabel == "perturbed":
            vs_f32 = tangent_check(split(out, grad), ref11, x, icfg, False,
                                   True)[0]
            ref11 = sweep_outputs(net, x, False, bf16w=True)
        fields, ok = tangent_check(split(out, grad), ref11, x, icfg, False)
        vs_k5, ok5 = tangent_check(split(out, grad), split(out5, grad5), x,
                                   icfg, False)
        fields.update(vs_f32=vs_f32, vs_rev_fwd=vs_k5)
        # K5 takes layer 0's encoding as a hi/lo pair, K11 in bf16: at the
        # perturbed weights K5 is the nearer to the f32 op, against which
        # K11 (as the JAX package's) is past the bound at a few points, so
        # there K11 may be past it against K5 at no more points than
        # against the f32 op
        if wlabel == "perturbed":
            ok5 = vs_k5["points_past"] <= vs_f32["points_past"]
        ok = ok and ok5
        if wlabel == "perturbed":
            bad = {f: tangent_check(sweep_outputs(net, x, False, f), ref11, x,
                                    icfg, False)
                   for f in tangent_faults(icfg, x[:1])}
            fields["fault_errs"] = {f: v[0] for f, v in bad.items()}
            fields["faults_caught"] = not any(v[1] for v in bad.values())
            ok = ok and fields["faults_caught"]
        b_ms, b_by = bound(2.0 * k5_macs(icfg) * n,
                           n * (12 + 4 * k.out_cols + 12) + 2 * n_w,
                           PEAK_BF16)

        def k11():
            with torch.no_grad():
                sdf_grad.sdf_grad_fwd(k, x)

        def lib11():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                sdf_grad.sdf_grad_plain(icfg, ws, bs, x)

        rows.append(dict(
            name="sdf_grad_fwd", route="cuda",
            source="i2sdf_tpu_torch/csrc/sdf_grad_fwd.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_grad.py:250",
            points=label, weights=wlabel, shape=[n, 3],
            max_abs_err=max(fields["errs"].values()), **fields,
            tolerances=TAN_TOLS, cos_tol=TAN_COS_TOL, macs=k5_macs(icfg),
            design_macs=tangent_design_macs(icfg), ms=time_ms(k11, 5),
            plain_ms=time_ms(lambda: sdf_grad.sdf_grad_plain(icfg, ws, bs,
                                                             x), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib11, 3)))
        emit_row(rows[-1], ok)
        del out, grad, out5, grad5
        # K12, with the loss's cotangents and with c_g alone: the second
        # isolates the tangent path, which the loss's sdf and feature
        # terms can outweigh in a leaf
        c_out, c_g = rev_cotangents(out_p, grad_p, SEED + 9)
        ref = torch.autograd.grad((out_p, grad_p), ws + bs, (c_out, c_g),
                                  retain_graph=True)
        no_out = torch.zeros_like(c_out)
        ref_g = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(grad_p, ws + bs, c_g, allow_unused=True),
            ws + bs)]
        del out_p, grad_p
        with torch.no_grad():
            k12p = sdf_grad.bwd_stages(icfg, ws, bs)
            got = [t for g in sdf_grad.sdf_grad_bwd(k12p, x, c_out, c_g)
                   for t in g]
            again = [t for g in sdf_grad.sdf_grad_bwd(k12p, x, c_out, c_g)
                     for t in g]
            got_g = [t for g in sdf_grad.sdf_grad_bwd(k12p, x, no_out, c_g)
                     for t in g]
            torch.cuda.synchronize()
            got6 = flat(rev.rev_bwd(kr, x, c_out, c_g))
        stable = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        gerrs = grad_errors(got, ref)
        is_k6 = all(torch.equal(a, b) for a, b in zip(got, got6))
        only_g = grad_errors(got_g, ref_g)
        ok = grads_ok(gerrs) and is_k6 and grads_ok(only_g) and stable
        fields = dict(**gerrs, grad_cotangent_only=only_g,
                      vs_rev_bwd=dict(grad_errors(got, got6),
                                      bitwise=is_k6),
                      bit_stable=stable)
        if wlabel == "perturbed":
            bad = {f: grad_errors(fault_vjp(net, x, no_out, c_g, f), ref_g)
                   for f in tangent_faults(icfg, x[:1])}
            fields["fault_errs"] = bad
            fields["faults_caught"] = not any(grads_ok(e)
                                              for e in bad.values())
            ok = ok and fields["faults_caught"]
        del got6, got_g, ref_g
        b_ms, b_by = bound(2.0 * k6_macs(icfg) * n,
                           n * (12 + 4 * k.out_cols + 12) + 2 * 2 * n_w
                           + 4 * n_p, PEAK_BF16)

        def k12():
            with torch.no_grad():
                sdf_grad.sdf_grad_bwd(k12p, x, c_out, c_g)

        def plain12():
            torch.autograd.grad(sdf_grad.sdf_grad_plain(icfg, ws, bs, x),
                                ws + bs, (c_out, c_g))

        def lib12():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                outs = sdf_grad.sdf_grad_plain(icfg, ws, bs, x)
            torch.autograd.grad(outs, ws + bs, (c_out, c_g))

        rows.append(dict(
            name="sdf_grad_bwd", route="cuda",
            source="i2sdf_tpu_torch/csrc/sdf_grad_bwd.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_grad.py:250",
            points=label, weights=wlabel, shape=[n, 3],
            cotangents=[k.out_cols, 3],
            staging_gb=k4_staging_gb(rev.plan_for(k12p, n)),
            max_abs_err=max(float((g - r).abs().max())
                            for g, r in zip(got, ref)),
            **fields, leaf_tol=GRAD_LEAF_TOL, cos_tol=GRAD_COS_TOL,
            macs=k6_macs(icfg), design_macs=k6_macs(icfg),
            ms=time_ms(k12, 5), device_ms=device_ms(k12, 5, K6_KERNELS),
            plain_ms=time_ms(plain12, 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib12, 2)))
        emit_row(rows[-1], ok)
        del ref, got, c_out, c_g, k, kr, k12p
        torch.cuda.empty_cache()
    return rows


def tangent_loss(sdf, feat, grad, gt_n):
    """The JAX package's loss for its tangent-kernel test
    (`tests/test_pallas_grad.py::_loss_terms`)."""
    nrm = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True),
                             min=1e-9)
    return ((sdf ** 2).mean() + 0.1 * (feat ** 2).mean()
            + 0.5 * (1 - (nrm * gt_n).sum(-1)).abs().mean()
            + 0.1 * ((torch.linalg.norm(grad, dim=-1) - 1) ** 2).mean())


def run_sdf_outputs(model, cfg, conf, device) -> dict:
    """The path of K10-K12: the two public entry points as a user calls
    them at full width. `fused_sdf_outputs` under no_grad over the first
    eval chunk's 1,164,000 sample points (the normal map's inputs), and
    `sdf_outputs_fused_grad` inside one backward of the JAX package's
    kernel-test loss over the normal-off step's 4,800 eikonal points.
    Every output finite, the normals unit where the gradient is non-zero
    and the gradient's median norm near 1 (the geometric init's SDF is a
    sphere's distance), every SDF leaf's gradient finite and non-zero, and
    K10, K11 and K12 each launched once (no other kernel)."""
    net = model.implicit
    x, _ = eval_chunk_points(cfg, conf, device)
    eik = eikonal_batch(cfg, conf, device, SEED + 8)
    gen = torch.Generator().manual_seed(SEED + 11)
    gt_n = torch.nn.functional.normalize(
        torch.randn((eik.shape[0], 3), generator=gen), dim=-1).to(device)
    leaves = list(net.parameters())
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        sdf, feat, grad = sdf_outputs.fused_sdf_outputs(net, x)
    loss = tangent_loss(*sdf_grad.sdf_outputs_fused_grad(net, eik), gt_n)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    seconds = time.perf_counter() - t0
    gnorm = torch.linalg.norm(grad, dim=-1)
    nz = gnorm > 0
    normals = grad[nz] / gnorm[nz, None]
    shapes = [list(t.shape) for t in (sdf, feat, grad)]
    finite = all(bool(torch.isfinite(t).all()) for t in (sdf, feat, grad))
    unit = float((torch.linalg.norm(normals, dim=-1) - 1).abs().max())
    leaf_ok = all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                  for g in grads)
    others = {k: v for k, v in launches.items()
              if k not in SDF_OUTPUTS_KERNELS and v}
    want = all(launches[k] == 1 for k in SDF_OUTPUTS_KERNELS)
    out = dict(points=x.shape[0], eikonal_points=eik.shape[0],
               shapes=shapes, finite=finite, nonzero_grad=float(
                   nz.float().mean()), normal_unit_err=unit,
               grad_norm_median=float(gnorm.median()),
               loss=float(loss.detach()),
               leaves=len(grads), leaves_finite_nonzero=leaf_ok,
               launches=launches, other_launches=others, seconds=seconds)
    if not (finite and leaf_ok and unit < 1e-3 and want and not others
            and 0.5 < out["grad_norm_median"] < 2.0
            and math.isfinite(out["loss"])
            and shapes == [[x.shape[0], 1], [x.shape[0],
                                             cfg.implicit.feature_vector_size],
                           [x.shape[0], 3]]):
        raise AssertionError(f"sdf_outputs path failed: {out}")
    return out


# ---- K7 conv_check, K8/K9 the background pair -----------------------------

def perray_conf(train: bool = True):
    """The perray config: `synthetic_quality.yml` with per-ray compaction at
    the pinned fractions (`train_conf`'s bubble window when training)."""
    conf = train_conf() if train else load_cfg(str(TRAIN_CONF))
    conf.dataset.scan_id = 1
    rs = conf.model.ray_sampler
    rs.per_ray_exit = True
    rs.per_ray_fracs = list(PER_RAY_FRACS)
    return conf


def bg_conf_path(tmp) -> str:
    """The bg config (`synthetic_quality.yml` with `BG_BLOCK`) written to
    `tmp`."""
    text = TRAIN_CONF.read_text()
    assert "    density:\n" in text
    path = Path(tmp) / "quality_bg.yml"
    path.write_text(text.replace("    density:\n",
                                 BG_BLOCK + "    density:\n"))
    return str(path)


def bg_conf(train: bool = True):
    with tempfile.TemporaryDirectory() as tmp:
        conf = load_cfg(bg_conf_path(tmp))
    conf.dataset.scan_id = 1
    if train:
        conf.loss.min_bubble_iter = 2
        conf.loss.max_bubble_iter = 4
        conf.train.uniform_bubble = True
    return conf


def k7_is_k2(sc, wk, beta0, conf, device, R) -> dict:
    """K7's flags against K2's decisions on the same rows, for the first R
    rays of view 0 at S = 416 and 480 and both of `check_kernels`' scenes
    (`mlp`: K1's SDF along the rays; `wall`): K2 launched once with beta in
    at 10 beta0, a ray's flag must be `beta_out == beta0`. {scene and S:
    the rays that disagree, and the flags set}."""
    _, dirs, cam = chunk_rays(conf, device, R)
    beta_in = (10.0 * beta0).expand(R).contiguous()
    u = torch.linspace(0, 1, 8, device=device).expand(R, 8).contiguous()
    out = {}
    for S in (416, 480):
        gen = torch.Generator().manual_seed(SEED + 12)
        z = torch.sort(torch.rand((R, S), generator=gen) * sc.far, -1).values
        z = z.to(device).contiguous()
        pts = (cam[:, None] + z[..., None] * dirs[:, None]).reshape(-1, 3)
        noise = 0.1 * torch.randn((R, S), generator=gen).to(device)
        scenes = {"mlp": sdf_mlp.sdf_mlp_nograd(
            wk.sdf, pts.contiguous()).reshape(R, S),
                  "wall": (3.0 - z + noise).contiguous()}
        for scene, sdf in scenes.items():
            got = conv_check.conv_check(sc, z, sdf, beta0)
            _, beta = sampler_round.sampler_round(sc, z, sdf, beta_in, beta0,
                                                  u, False)
            out[f"{scene}_{S}"] = dict(
                disagree=int((got != (beta == beta0)).sum()),
                converged=int(got.sum()))
    return out


def k7_sass(resources) -> dict | None:
    """K7's kernels' ptxas and SASS counts (E = 2, 4, 8 a thread)."""
    if resources is None:
        return None
    return {k: v for k, v in resources.get().items()
            if "conv_check_kernel" in k}


def check_conv(model, cfg, conf, device, resources=None) -> list[dict]:
    """K7 at the perray training shape (1600 rays) and an eval chunk (12,000
    rays), both at S = 416 (round 3 of the taper): the first rays of view
    0, sorted depths, the SDF of the seeded model by K1. Both flags must
    appear among the rays (in the f64 truth and in K7's output). At both
    R, K7's flags must equal K2's decisions to keep beta0 ray for ray
    (`k7_is_k2`)."""
    sc = cfg.sampler
    wk = renderer.KernelWeights.pack(model)
    beta0 = effective_beta(model.beta.detach(), cfg.beta_min)
    S = sum(sc.eval_counts[:4])
    rows = []
    for R in (K4_RAYS, conf.train.split_n_pixels):
        _, dirs, cam = chunk_rays(conf, device, R)
        gen = torch.Generator().manual_seed(SEED + 11)
        z = torch.sort(torch.rand((R, S), generator=gen) * sc.far, -1).values
        z = z.to(device).contiguous()
        pts = (cam[:, None] + z[..., None] * dirs[:, None]).reshape(-1, 3)
        sdf = sdf_mlp.sdf_mlp_nograd(wk.sdf, pts.contiguous()).reshape(R, S)
        got = conv_check.conv_check(sc, z, sdf, beta0)
        torch.cuda.synchronize()
        plain = tsampler.converged_rays(sc, z, sdf, beta0)
        z64, s64 = z.double().cpu(), sdf.double().cpu()
        d_star, dists = tsampler._d_star(z64, s64)
        b64 = tsampler._error_bound(beta0.double().cpu(), s64, dists, d_star)
        outside = ((b64 - sc.eps).abs() > CONV_BAND * sc.eps).to(device)
        truth = (b64 <= sc.eps).to(device)
        flips = (got != plain) | (got != truth)
        in_band = int((~outside).sum())
        # both flags must appear, so that a constant output fails
        mixed = 0 < int(truth.sum()) < R and 0 < int(got.sum()) < R
        k2 = k7_is_k2(sc, wk, beta0, conf, device, R)
        ok = (not bool((flips & outside).any())
              and in_band < CONV_BAND_SHARE * R and mixed
              and not any(v["disagree"] for v in k2.values()))
        b_ms, b_by = bound_f32(R * S * CONV_OPS_PER_SAMPLE,
                               R * S * EXP_PER_SAMPLE_EVAL, R * S * 8 + R)
        rows.append(dict(
            name="conv_check", route="cuda",
            source="i2sdf_tpu_torch/csrc/conv_check.cu",
            replaces="i2sdf_tpu/ops/pallas/sampler_round.py:355",
            shape=[R, S], max_abs_err=float((flips & outside).any()),
            converged=int(got.sum()),
            converged_share=float(got.float().mean()), in_band=in_band,
            flips_in_band=int((flips & ~outside).sum()), k2_decision=k2,
            sass=k7_sass(resources),
            ms=time_ms(lambda: conv_check.conv_check(sc, z, sdf, beta0), 20),
            device_ms=device_ms(lambda: conv_check.conv_check(
                sc, z, sdf, beta0), 20, "conv_check_kernel"),
            plain_ms=time_ms(lambda: tsampler.converged_rays(
                sc, z, sdf, beta0), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        emit_row(rows[-1], ok)
    return rows


def bg_points(cfg, conf, device, n_rays):
    """The background pair's inputs for the first `n_rays` rays of view 0:
    the sampler's eval inverse depths on the inverted sphere
    (N_samples_inverse_sphere a ray), flattened."""
    _, dirs, cam = chunk_rays(conf, device, n_rays)
    nbg = cfg.sampler.N_samples_inverse_sphere
    z = torch.linspace(0.0, 1.0, nbg, device=device).expand(n_rays, nbg)
    z = z * (1.0 / cfg.scene_bounding_sphere)
    _, x4, d = renderer._bg_inputs(cfg, z, dirs, cam.contiguous())
    return x4, d


def bg_layer_macs(icfg, rcfg) -> tuple[list, list]:
    """Multiply-adds per point of each background layer at its real width
    (implicit, radiance)."""
    rd = rcfg.layer_dims()
    return (sdf_layer_macs(icfg),
            [rd[l] * rd[l + 1] for l in range(len(rd) - 1)])


def k9_macs(icfg, rcfg) -> int:
    """K9 per point: the forward recompute, the radiance layers transposed
    (layer 0 cut to the features' rows), the implicit layers n-1 .. 1
    transposed (cut to the hidden part of their input) and one
    weight-gradient product a layer."""
    sd, rr = bg_layer_macs(icfg, rcfg)
    d, rd = icfg.layer_dims(), rcfg.layer_dims()
    F = icfg.feature_vector_size
    out = [d[l + 1] - (d[0] if l + 1 in icfg.skip_in else 0)
           for l in range(len(d) - 1)]
    keep = [d[l] - (d[0] if l in icfg.skip_in else 0)
            for l in range(len(d) - 1)]
    back_i = sum(keep[l] * out[l] for l in range(1, len(sd)))
    back_r = sum(rr[1:]) + F * rd[1]
    return 2 * (sum(sd) + sum(rr)) + back_i + back_r


def library_bg(icfg, rcfg, iw, ib, rw, rb, x4, dirs):
    """The pair as a bf16 torch.matmul chain (the library yardstick)."""
    inp = icfg.embed(x4).to(torch.bfloat16)
    h, n = inp, len(iw)
    for l in range(n):
        if l in icfg.skip_in:
            h = torch.cat([h, inp], -1) * (1 / math.sqrt(2))
        z = torch.matmul(h, iw[l]).float() + ib[l]
        h = softplus_beta(z).to(torch.bfloat16) if l < n - 1 else z
    sigma, feat = h[:, :1], h[:, 1:]
    h = torch.cat([rcfg.embed(dirs), feat], -1).to(torch.bfloat16)
    for l in range(len(rw)):
        z = torch.matmul(h, rw[l]).float() + rb[l]
        h = torch.relu(z).to(torch.bfloat16) if l < len(rw) - 1 else z
    return sigma, torch.sigmoid(h)


def bg_cotangents(sigma, rgb, seed):
    """[c_sigma | c_rgb] of a loss at these outputs: rgb L1 against seeded
    targets and 0.2 sigma^2."""
    gen = torch.Generator().manual_seed(seed)
    gt = torch.rand(rgb.shape, generator=gen).to(rgb.device)
    s, r = (t.detach().requires_grad_(True) for t in (sigma, rgb))
    with torch.enable_grad():
        loss = (r - gt).abs().mean() + 0.2 * (s ** 2).mean()
        cs, cr = torch.autograd.grad(loss, (s, r))
    return torch.cat([cs, cr], 1).contiguous()


def signal_bg_nets(implicit, rendering):
    """Copies of the background nets with every weight scaled by
    BG_SIGNAL_GAIN."""
    nets = copy.deepcopy(implicit), copy.deepcopy(rendering)
    with torch.no_grad():
        for net in nets:
            for lin in net.layers():
                (lin.g if lin.weight_norm else lin.w).mul_(BG_SIGNAL_GAIN)
    return nets


def bg_faults(icfg, rcfg, w, x4, dirs) -> dict:
    """The plain pair with one piece broken, as a faulty K8 would break it:
    the features zeroed, PE(view) of a constant direction, the skip
    layer's re-injected encoding dropped, x4's first two coordinates
    swapped."""
    out = mlp.implicit_apply(icfg, w.ws_i, w.bs_i, x4)
    ws = list(w.ws_i)
    skip, d0 = icfg.skip_in[0], icfg.layer_dims()[0]
    ws[skip] = torch.cat([ws[skip][:-d0], torch.zeros_like(ws[skip][-d0:])])
    noskip = mlp.implicit_apply(icfg, ws, w.bs_i, x4)
    swapped = mlp.implicit_apply(icfg, w.ws_i, w.bs_i, x4[:, [1, 0, 2, 3]])
    faults = {"features_zeroed": (out, dirs, torch.zeros_like(out[:, 1:])),
              "view_constant": (out, torch.zeros_like(dirs), out[:, 1:]),
              "skip_dropped": (noskip, dirs, noskip[:, 1:]),
              "x4_swapped": (swapped, dirs, swapped[:, 1:])}
    return {k: (o[:, :1], mlp.rendering_apply(rcfg, w.ws_r, w.bs_r, d, f))
            for k, (o, d, f) in faults.items()}


def spread_errors(got, ref) -> dict:
    """Per output (sigma, rgb): max|got - ref| over the spread of ref."""
    return {k: float((a - b).abs().max() / (b.max() - b.min()))
            for k, a, b in zip(("sigma", "rgb"), got, ref)}


def check_bg_signal(implicit, rendering, x4, d, faults: bool) -> tuple:
    """K8 at the nets scaled by BG_SIGNAL_GAIN against the plain pair, by
    the spread rule; with `faults`, each planted fault must fail that
    rule. Returns (fields for the row, ok)."""
    si, sr = signal_bg_nets(implicit, rendering)
    got = bg_core.bg_core_eval(bg_core.BgPack(si, sr), x4, d)
    torch.cuda.synchronize()
    w = bg_core.BgWeights.of(si, sr)
    with torch.no_grad():
        ref = bg_core.bg_core_plain(si.cfg, sr.cfg, w, x4, d)
        bad = ({k: spread_errors(v, ref) for k, v in bg_faults(
            si.cfg, sr.cfg, w, x4, d).items()} if faults else {})
    spread = {k: float(b.max() - b.min()) for k, b in zip(("sigma", "rgb"),
                                                          ref)}
    rel = spread_errors(got, ref)
    caught = all(max(e.values()) > BG_SPREAD_TOL for e in bad.values())
    ok = (max(rel.values()) <= BG_SPREAD_TOL and caught
          and min(spread.values()) >= BG_MIN_SPREAD)
    return dict(spread=spread, spread_errs=rel, fault_spread_errs=bad), ok


def bg_nets(model, cfg, device) -> dict:
    """The background nets K8 and K9 are checked on: the init's, perturbed
    (`perturbed_net`, seeds SEED + 30 and SEED + 31), and of odd depth
    (seven hidden layers, the skip one layer earlier, from a seeded init,
    perturbed): the init's zero encoding rows hide layout faults, and an
    exchange at every layer cancels over an even depth."""
    icfg, rcfg = cfg.bg_implicit, cfg.bg_rendering
    init = (model.bg_implicit, model.bg_rendering)
    odd = dataclasses.replace(icfg, dims=icfg.dims[:-1],
                              skip_in=tuple(s - 1 for s in icfg.skip_in))
    gen = torch.Generator().manual_seed(SEED + 32)
    raw = (mlp.ImplicitNet(odd, gen), mlp.RenderingNet(rcfg, gen))
    return {"init": init,
            "perturbed": tuple(perturbed_net(m, SEED + 30 + i)
                               for i, m in enumerate(init)),
            "odd": tuple(perturbed_net(m.to(device), SEED + 33 + i)
                         for i, m in enumerate(raw))}


def k8_errors(got, ref, spread=None) -> tuple[dict, bool]:
    """K8's outputs against its plain version: max errors, CORE_TOLS's sdf
    and rgb bounds, and the spread rule (over `spread`, the plain outputs
    of the whole point set, or `ref`'s own)."""
    tols = {"sigma": CORE_TOLS["sdf"], "rgb": CORE_TOLS["rgb"]}
    errs = {k: float((a - b).abs().max()) for k, a, b in zip(tols, got, ref)}
    spread = spread or {k: float(b.max() - b.min()) for k, b in zip(tols,
                                                                    ref)}
    rel = {k: errs[k] / spread[k] for k in tols}
    ok = (all(close(a, b, *tols[k]) for k, a, b in zip(tols, got, ref))
          and max(rel.values()) <= BG_SPREAD_TOL)
    return dict(errs=errs, spread_errs=rel), ok


def check_bg(model, cfg, conf, device,
             resources: dict | None = None) -> list[dict]:
    """K8 at an eval chunk (12,000 rays x 32 = 384,000 points) and a
    training batch (1600 x 32 = 51,200), K9 at the training batch with a
    seeded loss's cotangents, each against its plain version in f32 (at
    perturbed nets too: the JAX package's own pair stays inside the f32
    bounds there, `scripts/witness_perturbed.py bg`), on every net of
    `bg_nets`. K8 is held to CORE_TOLS and to
    the spread rule (BG_SPREAD_TOL), and at signal-scaled copies of the
    init's nets to the spread rule, the planted faults failing it at the
    training batch; K9 to the gradient check (`grads_ok`), two launches
    giving the same bits and padding rows adding nothing. Both also at the
    block-edge counts `BG_EDGE_COUNTS` (the training batch's first points,
    a few rays below 4,800): K8 by its rules, K9 by the gradient check
    from 4,800 points and below that to the same bits on a rerun, its
    errors recorded (on 2-4 rays a few bf16 flips outweigh the signal, as
    for K4: the kernel's replay, rounding as it does, reads the same
    errors there). Timed at the init's nets. `resources`: the
    `Resources` of `bg_core.cu` and `bg_core_bwd.cu`, for the rows'
    `sass`."""
    icfg, rcfg = cfg.bg_implicit, cfg.bg_rendering
    cases = bg_nets(model, cfg, device)
    init = cases["init"]
    pack = bg_core.BgPack(*init)
    w = bg_core.BgWeights.of(*init)
    iw, ib = _bf16_weights(model.bg_implicit)
    rw, rb = _bf16_weights(model.bg_rendering)
    sd, rr = bg_layer_macs(icfg, rcfg)
    n_w = sum(t.numel() for t in iw + rw)
    n_p = sum(t.numel() for t in w.flat())
    rows = []
    x4_t, d_t = bg_points(cfg, conf, device, K4_RAYS)
    for label, (x4, d) in (("train", (x4_t, d_t)), ("eval", bg_points(
            cfg, conf, device, conf.train.split_n_pixels))):
        n = x4.shape[0]
        fields, ok = {}, True
        for which, nets in cases.items():
            got = bg_core.bg_core_eval(bg_core.BgPack(*nets), x4, d)
            torch.cuda.synchronize()
            with torch.no_grad():
                ref = bg_core.bg_core_plain(nets[0].cfg, rcfg,
                                            bg_core.BgWeights.of(*nets), x4,
                                            d)
            fields[which], case_ok = k8_errors(got, ref)
            ok = ok and case_ok
            if label == "train" and which != "odd":
                spread = {k: float(b.max() - b.min())
                          for k, b in zip(("sigma", "rgb"), ref)}
                edges = {}
                for m in BG_EDGE_COUNTS:
                    sub = (x4[:m].contiguous(), d[:m].contiguous())
                    e, e_ok = k8_errors(
                        bg_core.bg_core_eval(bg_core.BgPack(*nets), *sub),
                        tuple(t[:m] for t in ref), spread)
                    edges[m] = max(e["spread_errs"].values())
                    ok = ok and e_ok
                fields[which]["edges_spread_err"] = edges
        signal, signal_ok = check_bg_signal(
            model.bg_implicit, model.bg_rendering, x4, d, label == "train")
        ok = ok and signal_ok
        b_ms, b_by = bound(2.0 * (sum(sd) + sum(rr)) * n,
                           n * (16 + 12 + 16) + 2 * n_w, PEAK_BF16)

        def plain_fwd():
            with torch.no_grad():
                bg_core.bg_core_plain(icfg, rcfg, w, x4, d)

        rows.append(dict(
            name="bg_core_fwd", route="cuda",
            source="i2sdf_tpu_torch/csrc/bg_core.cu",
            replaces="i2sdf_tpu/ops/pallas/fused_bg.py:209",
            points=label, shape=[n, 4],
            max_abs_err=max(fields["init"]["errs"].values()),
            **fields["init"], perturbed=fields["perturbed"],
            odd=fields["odd"], tolerances={"sigma": CORE_TOLS["sdf"], "rgb": CORE_TOLS["rgb"]},
            spread_tol=BG_SPREAD_TOL, signal=signal,
            sass=(resources["bg_core.cu"].get()
                  if resources and label == "train" else None),
            ms=time_ms(lambda: bg_core.bg_core_eval(pack, x4, d), 5),
            plain_ms=time_ms(plain_fwd, 2), bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: library_bg(icfg, rcfg, iw, ib, rw, rb,
                                                  x4, d), 3)))
        emit_row(rows[-1], ok)
    # K9 at the training batch
    x4, d = x4_t, d_t
    fields, ok = {}, True
    for which, nets in cases.items():
        wr = bg_core.BgWeights.of(*nets)
        sigma, rgb = bg_core.bg_core_plain(nets[0].cfg, rcfg, wr, x4, d)
        cot = bg_cotangents(sigma, rgb, SEED + 12)
        ref = torch.autograd.grad((sigma, rgb), wr.flat(),
                                  (cot[:, :1], cot[:, 1:]))
        with torch.no_grad():
            st = bg_core.BgStages(nets[0].cfg, rcfg, wr)
            got = [t for g in bg_core.bg_core_bwd(st, x4, d, cot) for t in g]
            again = [t for g in bg_core.bg_core_bwd(st, x4, d, cot)
                     for t in g]
        torch.cuda.synchronize()
        fields[which] = grad_errors(got, ref)
        fields[which]["bitwise_rerun"] = all(
            torch.equal(a, b) for a, b in zip(got, again))
        ok = (ok and grads_ok(fields[which])
              and fields[which]["bitwise_rerun"])
        if which == "init":
            k, cot0 = st, cot
            max_abs = max(float((g - r).abs().max())
                          for g, r in zip(got, ref))
        if which != "odd":
            edges = {}
            for m in BG_EDGE_COUNTS:
                sub = (x4[:m].contiguous(), d[:m].contiguous())
                s_m, r_m = bg_core.bg_core_plain(nets[0].cfg, rcfg, wr, *sub)
                c_m = bg_cotangents(s_m, r_m, SEED + 13)
                ref_m = torch.autograd.grad((s_m, r_m), wr.flat(),
                                            (c_m[:, :1], c_m[:, 1:]))
                with torch.no_grad():
                    got_m = [t for g in bg_core.bg_core_bwd(st, *sub, c_m)
                             for t in g]
                    again_m = [t for g in bg_core.bg_core_bwd(st, *sub, c_m)
                               for t in g]
                e = grad_errors(got_m, ref_m)
                e["bitwise_rerun"] = all(torch.equal(a, b)
                                         for a, b in zip(got_m, again_m))
                edges[m] = e
                ok = ok and e["bitwise_rerun"] and (m < 4800 or grads_ok(e))
            fields[which]["edges"] = edges
    # padding rows: 33 points, and the same 33 plus 31 rows with zero
    # cotangents (one block of 64), to the bit
    with torch.no_grad():
        c64 = cot0[:64].clone()
        c64[33:] = 0.0
        a33 = bg_core.bg_core_bwd(k, x4[:33].contiguous(),
                                  d[:33].contiguous(), c64[:33].contiguous())
        a64 = bg_core.bg_core_bwd(k, x4[:64].contiguous(),
                                  d[:64].contiguous(), c64)
    padding_ok = all(torch.equal(p, q) for g, h in zip(a33, a64)
                     for p, q in zip(g, h))
    ok = ok and padding_ok
    n = x4.shape[0]
    b_ms, b_by = bound(2.0 * k9_macs(icfg, rcfg) * n,
                       n * (16 + 12 + 16) + 2 * n_w + 4 * n_p, PEAK_BF16)
    cots = (cot0[:, :1], cot0[:, 1:])

    def kernel():
        with torch.no_grad():
            bg_core.bg_core_bwd(k, x4, d, cot0)

    def plain():
        torch.autograd.grad(bg_core.bg_core_plain(icfg, rcfg, w, x4, d),
                            w.flat(), cots)

    def library():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            outs = bg_core.bg_core_plain(icfg, rcfg, w, x4, d)
        torch.autograd.grad(outs, w.flat(), cots)

    plan = bg_core.plan_for(k, n)
    rows.append(dict(
        name="bg_core_bwd", route="cuda",
        source="i2sdf_tpu_torch/csrc/bg_core_bwd.cu",
        replaces="i2sdf_tpu/ops/pallas/fused_bg.py:209",
        points="train", shape=[n, 4], max_abs_err=max_abs,
        **{k_: v for k_, v in fields["init"].items() if k_ != "edges"},
        edges=fields["init"]["edges"], perturbed=fields["perturbed"],
        odd=fields["odd"], padding_rows_add_nothing=padding_ok,
        leaf_tol=GRAD_LEAF_TOL, cos_tol=GRAD_COS_TOL,
        staging_gb=k4_staging_gb(plan),
        sass=resources["bg_core_bwd.cu"].get() if resources else None,
        ms=time_ms(kernel, 5), plain_ms=time_ms(plain, 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 2)))
    emit_row(rows[-1], ok)
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
    # K3 and K4 are each one kernel template (with the light head or
    # not); K4's, K6's and K9's products are `wgrad_kernel<4>`, `<6>` and
    # `<9>`, their sums `sum_kernel` (K12, which is K6, runs on no step)
    groups = {"K1 sdf_mlp": "sdf_mlp_kernel", "K2 sampler_round":
              "sampler_round",
              "K3 render_core_fwd": "render_core_kernel<false>",
              "K3 render_core_fwd_light": "render_core_kernel<true>",
              "K5 rev_fwd": "k5_sweep_kernel",
              "K4 sweep": "k4_sweep_kernel<false",
              "K4 sweep light": "k4_sweep_kernel<true",
              "K4 products": "wgrad_kernel<4>",
              "K6 sweep": "k6_sweep_kernel",
              "K6 products": "wgrad_kernel<6>",
              "K7 conv_check": "conv_check_kernel",
              "K8 bg_core_fwd": "bg_fwd_kernel",
              "K9 sweep": "bg_sweep_kernel",
              "K9 products": "wgrad_kernel<9>",
              "K4/K6/K9 sum": "sum_kernel"}
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


PACKERS = ((render_core, "CoreStages"), (render_core, "K4Stages"),
           (rev, "RevStages"), (bg_core, "BgStages"))
# packing that finishes a pack later (K9's transposed chain, packed in the
# backward): timed with the packing, not counted as a pack
LATE_PACKERS = ((bg_core.BgStages, "pack_t"),)


def host_split(tr, step0: int, n: int = 2) -> dict:
    """A step's wall time in four parts (ms a step, n steps from step0, no
    profiler): `syncs`, the host blocked in the step's syncs on CUDA
    tensors (`bool`, `float`, `item`: one a sampler round, the step's
    beta), the device catching up there; `packing`, the host packing the
    kernels' weights (K3's `CoreStages`, K4's `K4Stages`, K5/K6's
    `RevStages`, K8/K9's `BgStages` and its `pack_t`; their device work
    runs behind);
    `rest`, the wait at the step's end for the device to finish its queue;
    `python`, the remainder: the Python step, the dispatch of its
    operations, and any blocking call not wrapped here. The wrappers that time the first two cost the host a few
    microseconds a call."""
    spent = {"syncs": 0.0, "packing": 0.0}
    calls = {"syncs": 0, "packing": 0}

    def timed(kind, fn, count=True):
        def wrapper(*a, **k):
            if kind == "syncs" and not a[0].is_cuda:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[kind] += time.perf_counter() - t0
                calls[kind] += count
        return wrapper

    saved = [(torch.Tensor, m, getattr(torch.Tensor, m))
             for m in ("__bool__", "__float__", "item")]
    saved += [(getattr(mod, c), "__init__", getattr(mod, c).__init__)
              for mod, c in PACKERS]
    late = [(obj, m, getattr(obj, m)) for obj, m in LATE_PACKERS]
    wall = tail = 0.0
    try:
        for obj, m, fn in saved:
            setattr(obj, m, timed("syncs" if obj is torch.Tensor
                                  else "packing", fn))
        for obj, m, fn in late:
            setattr(obj, m, timed("packing", fn, count=False))
        for s in range(step0, step0 + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step_fn(tr.state, tr.device_data, tr.draws(s),
                       tr.loss_cfg.dynamic_weights(s), tr.bubble)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            wall += t2 - t0
            tail += t2 - t1
    finally:
        for obj, m, fn in saved + late:
            setattr(obj, m, fn)
    ms = lambda v: v * 1e3 / n  # noqa: E731
    return dict(steps=n, wall_ms=ms(wall), syncs_ms=ms(spent["syncs"]),
                syncs_per_step=calls["syncs"] / n,
                packing_ms=ms(spent["packing"]),
                packs_per_step=calls["packing"] / n, rest_ms=ms(tail),
                python_ms=ms(wall - tail - spent["syncs"]
                             - spent["packing"]))


def images_only_root(tmp, light_masks: bool = False) -> str:
    """A data root whose scan1 holds only the checkout's images and
    cameras (symlinks), so no depth, normal or light-mask file of the
    checkout is read wherever this runs; with `light_masks`, seeded grey
    PNG light masks at the images' shape (a tenth of the pixels lit),
    written there."""
    src = ROOT / "data" / "synthetic_quality" / "scan1"
    scan = Path(tmp) / "data" / "synthetic_quality" / "scan1"
    scan.mkdir(parents=True)
    for name in ("image", "cameras_normalize.npz"):
        os.symlink(src / name, scan / name)
    if light_masks:
        images = imaging.glob_imgs(str(src / "image"), (".png",))
        H, W = imaging.read_png(images[0]).shape[:2]
        rng = np.random.default_rng(SEED + 10)
        (scan / "light_mask").mkdir()
        for i in range(len(images)):
            lit = rng.uniform(size=(H, W)) < 0.1
            imaging.write_png(str(scan / "light_mask" / f"{i:04d}.png"),
                              (lit * 255).astype(np.uint8))
    return str(Path(tmp) / "data")


def light_conf(train: bool = True):
    """A copy of the light config on scan1 of the checkout (its own
    `data_dir` is a scene the checkout does not hold); for training, the
    bubble window moved to steps 2-3 with a uniform pdf, as `train_conf`."""
    conf = load_cfg(str(LIGHT_CONF))
    conf.dataset.data_dir = "synthetic_quality"
    conf.dataset.scan_id = 1
    if train:
        conf.loss.min_bubble_iter = 2
        conf.loss.max_bubble_iter = 4
        conf.train.uniform_bubble = True
    return conf


TRAIN_CONFS = {"train": train_conf, "nonormal": train_conf,
               "light": light_conf, "perray": perray_conf, "bg": bg_conf}
TRAIN_WANT = {"train": TRAIN_KERNELS, "nonormal": NONORMAL_KERNELS,
              "light": LIGHT_KERNELS, "perray": PERRAY_KERNELS,
              "bg": BG_KERNELS}


def run_train(device, kind: str = "train") -> dict:
    """6 steps through the trainer (counts taken around each step; the
    validation render at the end of `fit` runs the eval path). `kind`:

    * `train`: the flagship step, K1-K4, K4 once a step;
    * `nonormal` (`normal_weight: 0`, no normal maps): the rev route, K5
      and K6 once a step, K3 and K4 never;
    * `light`: the light config with seeded light masks: K3 and K4 with
      the light head once a step, the light-mask loss on at every step,
      every light-net leaf moved;
    * `perray`: per-ray compaction at the pinned fractions: K7 four times
      a step (once a refinement round), K3/K4 once;
    * `bg`: the NeRF++ background: K8 and K9 once a step beside K1-K4,
      every background leaf moved."""
    conf = TRAIN_CONFS[kind]()
    normal, light = kind != "nonormal", kind == "light"
    if not normal:
        conf.loss.normal_weight = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        tr = ReconstructionTrainer(conf, os.path.join(tmp, "exp"),
                                   data_root=images_only_root(tmp, light),
                                   device=device, seed=SEED)
        data = tr.train_data
        assert tr.device_data.depth is None and tr.device_data.normal is None
        assert tr.model_cfg.use_normal == normal
        assert tr.model_cfg.use_light == light == data.use_lightmask
        synthetic_supervision(data, SEED + 6, normals=normal)
        tr.device_data = data.to_device(device)
        light0 = ([p.detach().clone() for p in tr.state.model.light
                   .parameters()] if light else [])
        bg0 = {k: p.detach().clone()
               for k, p in tr.state.model.named_parameters()
               if k.startswith("bg_")}
        assert bool(bg0) == (kind == "bg") == tr.model_cfg.use_bg
        assert tr.per_ray == (kind == "perray")
        times, seen, per_step = [], [], []
        if tr.per_ray:  # the phase's step first, so that `timed` wraps it
            tr.update_per_ray_phase()
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
        want = TRAIN_WANT[kind]
        missing = [k for k in want if launches[k] == 0]
        assert not missing, f"kernels not launched on the path: {missing}"
        if light:
            for c in per_step:
                assert (c["render_core_fwd_light"]
                        == c["render_core_bwd_light"] == 1), c
                assert c["render_core_fwd"] == c["render_core_bwd"] == 0, c
            for m, _ in seen:
                assert m["light_mask_loss"] > 0, m
            moved = [float((a.detach() - b).abs().max()) for a, b in zip(
                tr.state.model.light.parameters(), light0)]
            assert all(v > 0 for v in moved), moved
        elif kind == "perray":
            assert tr.per_ray_fracs == PER_RAY_FRACS, tr.per_ray_fracs
            n_checks = tr.model_cfg.sampler.max_total_iters - 1
            for c in per_step:
                assert c["conv_check"] == n_checks, c
                assert c["render_core_fwd"] == c["render_core_bwd"] == 1, c
        elif kind == "bg":
            for c in per_step:
                assert c["bg_core_fwd"] == c["bg_core_bwd"] == 1, c
                assert c["render_core_fwd"] == c["render_core_bwd"] == 1, c
            params = dict(tr.state.model.named_parameters())
            moved = {k: float((params[k].detach() - v).abs().max())
                     for k, v in bg0.items()}
            assert all(v > 0 for v in moved.values()), moved
        elif normal:
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
        split = host_split(tr, TRAIN_STEPS)
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
            # the median of steps 1-5 and the mean of steps 4-5 (after
            # the bubble window), in ms
            median_ms=statistics.median(steady) * 1e3,
            steps45_ms=statistics.mean(times[4:6]) * 1e3,
            rays_per_s=tr.batch_size / statistics.median(steady),
            host_split=split,
            losses=[m["loss"] for m, _ in seen],
            light_mask_losses=([m["light_mask_loss"] for m, _ in seen]
                               if light else None),
            pointcloud=int(data.pointcloud.shape[0]),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            profile=prof, kernel_vs_plain=cmp)
        del tr
    torch.cuda.empty_cache()
    return out


def run_eval_perray(device) -> dict:
    """One view of the perray config (seeded init) through the eval entry
    point, the sizes K1, K2 and K7 see recorded on the way (points for K1,
    rays for K2 and K7): after the first compacted round they run on the
    capped rows. Then the first chunk through the plain path."""
    conf = perray_conf(train=False)
    cfg, model = seeded_model(conf, device)
    sizes = {"sdf_mlp_nograd": [], "sampler_round": [], "conv_check": []}
    orig = (sdf_mlp.sdf_mlp_nograd, sampler_round.sampler_round,
            conv_check.conv_check)

    def k1(p, pts):
        sizes["sdf_mlp_nograd"].append(pts.shape[0])
        return orig[0](p, pts)

    def k2(sc, z, *a):
        sizes["sampler_round"].append(z.shape[0])
        return orig[1](sc, z, *a)

    def k7(sc, z, *a):
        sizes["conv_check"].append(z.shape[0])
        return orig[2](sc, z, *a)

    sdf_mlp.sdf_mlp_nograd, sampler_round.sampler_round = k1, k2
    conv_check.conv_check = k7
    try:
        sl = run_slice(model, conf, device, want=EVAL_PERRAY_KERNELS)
    finally:
        (sdf_mlp.sdf_mlp_nograd, sampler_round.sampler_round,
         conv_check.conv_check) = orig
    R = conf.train.split_n_pixels
    cap = tsampler.per_ray_caps(cfg.sampler, R)[1]
    # the first chunk: K2 on all rays, then on the capped rows, last on all
    first = sizes["sampler_round"][:cfg.sampler.max_total_iters]
    assert first[0] == R and first[-1] == R and cap < R, first
    assert all(r == cap for r in first[1:-1]), (first, cap)
    assert min(sizes["sdf_mlp_nograd"]) < R * min(cfg.sampler.eval_counts)
    assert sl["launches"]["conv_check"] == (
        sl["chunks"] * (cfg.sampler.max_total_iters - 1)), sl["launches"]
    cmp = compare_chunk(model, conf, device)
    del model
    torch.cuda.empty_cache()
    n_rounds = cfg.sampler.max_total_iters
    return dict(**sl, compare=cmp, fracs=list(PER_RAY_FRACS), cap=cap,
                first_chunk_sizes={
                    "sdf_mlp_nograd": sizes["sdf_mlp_nograd"][:n_rounds],
                    "sampler_round": first,
                    "conv_check": sizes["conv_check"][:n_rounds - 1]})


def run_eval_bg(device) -> dict:
    """One view of the bg config (seeded init) through the eval entry
    point: K8 once a chunk, K9 never; then the first chunk through the
    plain path."""
    conf = bg_conf(train=False)
    cfg, model = seeded_model(conf, device)
    sl = run_slice(model, conf, device, want=EVAL_BG_KERNELS,
                   never=("bg_core_bwd",))
    assert sl["launches"]["bg_core_fwd"] == sl["chunks"], sl["launches"]
    cmp = compare_chunk(model, conf, device)
    del model
    torch.cuda.empty_cache()
    return dict(**sl, compare=cmp)


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
    return dict(runs=runs + run_cli_light() + run_cli_bg(), checkpoints=ckpts,
                plots=plots, rendered_step=4, eval_files=evals,
                image=list(depth.shape))


def run_cli_light() -> list:
    """The train CLI for 2 steps on a copy of the light config (scan1 of
    the checkout, seeded light masks), then the render CLI on its newest
    checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        conf = Path(tmp) / "light_mask.yml"
        conf.write_text(LIGHT_CONF.read_text().replace(
            "data_dir: synthetic\n", "data_dir: synthetic_quality\n"))
        cli = [sys.executable, "-m", "i2sdf_tpu_torch.main", "--scan_id",
               "1", "--data_root", images_only_root(tmp, light_masks=True),
               "--log_every", "1", "--conf", str(conf), "--exps_folder",
               str(Path(tmp) / "exps")]
        runs = []
        for extra in (["--max_steps", "2"],
                      ["--test", "--test_mode", "render", "--indices", "0"]):
            t0 = time.perf_counter()
            proc = subprocess.run(cli + extra, cwd=ROOT, capture_output=True,
                                  text=True, timeout=600)
            logs = [ln for ln in proc.stdout.splitlines() if "[scan1 " in ln]
            runs.append(dict(args=["light"] + extra, rc=proc.returncode,
                             seconds=time.perf_counter() - t0,
                             tail=logs or proc.stdout.strip().splitlines()
                             [-3:]))
            assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[
                -3000:]
        assert "[INFO] restored checkpoint @2" in proc.stdout, proc.stdout
        assert len(runs[0]["tail"]) == 2 and all(
            "light_mask=" in ln for ln in runs[0]["tail"]), runs[0]
        exp = Path(tmp) / "exps" / "synthetic_light_1" / "version_0"
        lplots = sorted(p.name for p in (exp / "plots" / "light_mask")
                        .glob("*.png"))
        depth = np.load(exp / "eval" / "depth" / "0000.npy")
    assert lplots and np.isfinite(depth).all(), (lplots, depth.shape)
    runs[-1]["light_mask_plots"] = lplots
    return runs


def run_cli_bg() -> list:
    """The train CLI for 2 steps on the bg config (scan1 of the checkout,
    images and cameras only), then the render CLI on its newest
    checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        cli = [sys.executable, "-m", "i2sdf_tpu_torch.main", "--scan_id",
               "1", "--data_root", images_only_root(tmp), "--log_every", "1",
               "--conf", bg_conf_path(tmp), "--exps_folder",
               str(Path(tmp) / "exps")]
        runs = []
        for extra in (["--max_steps", "2"],
                      ["--test", "--test_mode", "render", "--indices", "0"]):
            t0 = time.perf_counter()
            proc = subprocess.run(cli + extra, cwd=ROOT, capture_output=True,
                                  text=True, timeout=600)
            logs = [ln for ln in proc.stdout.splitlines() if "[scan1 " in ln]
            runs.append(dict(args=["bg"] + extra, rc=proc.returncode,
                             seconds=time.perf_counter() - t0,
                             tail=logs or proc.stdout.strip().splitlines()
                             [-3:]))
            assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[
                -3000:]
        assert "[INFO] restored checkpoint @2" in proc.stdout, proc.stdout
        assert len(runs[0]["tail"]) == 2, runs[0]
        exp = Path(tmp) / "exps" / "quality_1" / "version_0"
        depth = np.load(exp / "eval" / "depth" / "0000.npy")
        pred = imaging.read_png(str(exp / "eval" / "rendering"
                                    / "0000_pred.png"))
    assert np.isfinite(depth).all() and pred.shape[:2] == depth.shape
    return runs


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
    k4_res = Resources("i2sdf_tpu_torch/csrc/render_core_bwd.cu")
    k2_res = Resources("i2sdf_tpu_torch/csrc/sampler_round.cu",
                       "i2sdf_tpu_torch/csrc/conv_check.cu")
    rev_res = Resources("i2sdf_tpu_torch/csrc/rev_fwd.cu",
                        "i2sdf_tpu_torch/csrc/rev_bwd.cu")
    bg_res = {src: Resources(f"i2sdf_tpu_torch/csrc/{src}")
              for src in ("bg_core.cu", "bg_core_bwd.cu")}
    k10_res = Resources("i2sdf_tpu_torch/csrc/sdf_outputs.cu")

    conf = eval_conf()
    cfg, model = seeded_model(conf, device)

    t0 = time.perf_counter()
    rows = check_kernels(model, cfg, conf, device, k2_res)
    rows += check_sdf_outputs(model, cfg, conf, device, k10_res)
    tconf = train_conf()
    tcfg, tmodel = seeded_model(tconf, device)
    rows.append(check_k4(tmodel, tcfg, conf, device, resources=k4_res))
    torch.cuda.empty_cache()
    rows += check_rev(tmodel, tcfg, conf, device, rev_res)
    rows += check_sdf_grad(tmodel, tcfg, conf, device)
    del tmodel
    # K3 and K4 with the light head, at the light config's full width
    lconf = light_conf(train=False)
    lcfg, lmodel = seeded_model(lconf, device)
    rows.append(check_k3(lmodel, lcfg, lconf, device))
    torch.cuda.empty_cache()
    for detach in (True, False):
        rows.append(check_k4(lmodel, lcfg, lconf, device, detach,
                             resources=k4_res))
        torch.cuda.empty_cache()
    del lmodel
    # K7 at the perray config, K8 and K9 at the bg config (full width)
    pconf = perray_conf(train=False)
    pcfg, pmodel = seeded_model(pconf, device)
    rows += check_conv(pmodel, pcfg, pconf, device, k2_res)
    del pmodel
    bconf = bg_conf(train=False)
    bcfg, bmodel = seeded_model(bconf, device)
    rows += check_bg(bmodel, bcfg, bconf, device, resources=bg_res)
    del bmodel
    torch.cuda.empty_cache()
    emit("kernels", t0, n=len(rows))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    so = run_sdf_outputs(model, cfg, conf, device)
    emit("sdf_outputs", t0, **so)
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
    trn = run_train(device, "nonormal")
    emit("train_nonormal", t0, **trn)

    t0 = time.perf_counter()
    lconf = light_conf(train=False)
    lcfg, lmodel = seeded_model(lconf, device)
    sll = run_slice(lmodel, lconf, device, want=EVAL_LIGHT_KERNELS)
    cmpl = compare_chunk(lmodel, lconf, device)
    emit("eval_light", t0, **sll, compare=cmpl)
    del lmodel
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trl = run_train(device, "light")
    emit("train_light", t0, **trl)

    t0 = time.perf_counter()
    slp = run_eval_perray(device)
    emit("eval_perray", t0, **slp)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trp = run_train(device, "perray")
    emit("train_perray", t0, **trp)

    t0 = time.perf_counter()
    slb = run_eval_bg(device)
    emit("eval_bg", t0, **slb)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trb = run_train(device, "bg")
    emit("train_bg", t0, **trb)

    t0 = time.perf_counter()
    cli = run_cli()
    emit("cli", t0, **cli)

    per_kernel = {}
    for row in rows:  # one entry per kernel: its main-path shape's row
        per_kernel.setdefault(row["name"], row)
    # each kernel's launches from the training path it serves: K1-K4 the
    # normal-on step's (`train`), K5/K6 the normal-off step's, K3 and K4
    # with the light head the light config's step's, K7 the perray
    # config's, K8 and K9 the bg config's, K10-K12 the `sdf_outputs` phase's
    path_of = {k: ("sdf_outputs" if k in SDF_OUTPUTS_KERNELS else
                   "train_nonormal" if k.startswith("rev_") else
                   "train_light" if k.endswith("_light") else
                   "train_perray" if k == "conv_check" else
                   "train_bg" if k.startswith("bg_core") else "train")
               for k in per_kernel}
    paths = {"train": tr["launches"], "train_nonormal": trn["launches"],
             "train_light": trl["launches"], "train_perray": trp["launches"],
             "train_bg": trb["launches"], "sdf_outputs": so["launches"]}
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"launches": {"eval": sl["launches"],
                                   "train": tr["launches"],
                                   "train_nonormal": trn["launches"],
                                   "eval_light": sll["launches"],
                                   "train_light": trl["launches"],
                                   "eval_perray": slp["launches"],
                                   "train_perray": trp["launches"],
                                   "eval_bg": slb["launches"],
                                   "train_bg": trb["launches"],
                                   "sdf_outputs": so["launches"]},
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
