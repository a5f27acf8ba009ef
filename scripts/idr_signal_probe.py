"""Why the smoke's idr checks scale the radiance net (`chip_smoke.signal_net`).

    JAX_PLATFORMS=cpu python scripts/idr_signal_probe.py

On the CPU, at the idr config's full widths (`synthetic_quality.yml` with
`chip_smoke.IDR_EDIT`: VolSDF's DTU radiance net) at the smoke's seeded
init, 3,000 points uniform in the scene's cube with random unit
directions, for the radiance net as it is and with every weight scaled by
`chip_smoke.BG_SIGNAL_GAIN` (and by 3):

* rgb's spread over the points (max - min);
* how far rgb moves when the xyz and gradient columns of the radiance
  input are swapped (what `k3_idr_pts_grad_swapped` plants in K3);
* the worst leaf error (`max|d| / max|ref|` over the SDF net's leaves)
  when the radiance input's gradient cotangent is left out (what
  `k4_idr_grad_cot_dropped` plants in K4), with the cotangents of the
  JAX kernel test's loss and with its rgb term alone;

K3-idr's bf16 replay (`test_torch_kernel_layout.emulate_render_core`,
2,048 of the points) at the scaled net against the plain op at its bf16
weights; and K4-idr's bf16 replay (`test_torch_bwd_replay.emulate_bwd`)
on a subsample of the smoke's training batch (`chip_smoke.k4_batch`: 32
of its rays, 800 eikonal rows), at the scaled net with radiance layer
0's gradient rows scaled by 1, 3 and `chip_smoke.IDR_GRAD_GAIN`
(`chip_smoke.idr_signal_net`) and the rgb cotangent alone, against the
plain f32 backward, as it is and with the gradient columns' cotangent
left out. Prints one JSON line each; about 5 minutes.
"""

from __future__ import annotations

import copy
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import chip_smoke  # noqa: E402
from i2sdf_tpu_torch.models import mlp, renderer  # noqa: E402
from i2sdf_tpu_torch.ops.kernels import render_core  # noqa: E402
from test_torch_bwd_replay import (emulate_bwd, grad_check,  # noqa: E402
                                   loss_cotangents, plain_vjp)
from test_torch_kernel_layout import emulate_render_core  # noqa: E402


def scaled(model, gain):
    m = copy.deepcopy(model)
    with torch.no_grad():
        for lin in m.rendering.layers():
            lin.g.mul_(gain)
    return m


def sdf_leaf_errs(cfg, m, x, d, only_rgb):
    """Worst and median SDF-leaf error of the gradient with the radiance
    input's gradient detached against the full one."""
    grads = []
    for detach in (False, True):
        w = render_core.CoreWeights.of(m.implicit, m.rendering)
        with torch.enable_grad():
            xg = x.clone().requires_grad_(True)
            out = mlp.implicit_apply(cfg.implicit, w.ws_sdf, w.bs_sdf, xg)
            sdf, feat = out[:, :1], out[:, 1:]
            (g,) = torch.autograd.grad(sdf, xg, torch.ones_like(sdf),
                                       create_graph=True)
            rgb = mlp.rendering_apply(cfg.rendering, w.ws_rad, w.bs_rad, d,
                                      feat, x, g.detach() if detach else g)
            gen = torch.Generator().manual_seed(1)
            loss = (rgb - torch.rand(rgb.shape, generator=gen)).abs().mean()
            if not only_rgb:
                gn = torch.nn.functional.normalize(
                    torch.randn(g.shape, generator=gen), dim=-1)
                nrm = g / g.norm(dim=-1, keepdim=True).clamp(min=1e-9)
                loss = (loss + 0.2 * (sdf ** 2).mean()
                        + 0.5 * (1 - (nrm * gn).sum(-1)).abs().mean()
                        + 0.1 * ((g.norm(dim=-1) - 1) ** 2).mean())
            grads.append(torch.autograd.grad(
                loss, list(m.implicit.parameters())))
    errs = sorted(float((a - b).abs().max() / max(float(b.abs().max()), 1e-3))
                  for a, b in zip(grads[1], grads[0]))
    return (errs[-1], errs[len(errs) // 2],
            float(rgb.detach().max() - rgb.detach().min()))


def main() -> int:
    conf = chip_smoke.idr_conf(train=False)
    cfg = renderer.I2SDFConfig.from_cfgnode(conf.model)
    model = renderer.I2SDFModel(cfg, seed=chip_smoke.SEED)
    rng = np.random.default_rng(0)
    s = cfg.scene_bounding_sphere
    x = torch.from_numpy(rng.uniform(-s, s, (3000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(3000, 3)).astype(np.float32)), dim=-1)
    for gain in (1.0, chip_smoke.BG_SIGNAL_GAIN, 3.0):
        m = scaled(model, gain)
        with torch.no_grad():
            w = render_core.CoreWeights.of(m.implicit, m.rendering)
            _, g, rgb = render_core.render_core_train_plain(
                cfg.implicit, cfg.rendering, w, x, d)
            feat = mlp.implicit_apply(cfg.implicit, w.ws_sdf, w.bs_sdf,
                                      x)[:, 1:]
            swapped = mlp.rendering_apply(cfg.rendering, w.ws_rad, w.bs_rad,
                                          d, feat, g, x)
        row = {"gain": gain,
               "swap_rgb_max_diff": float((swapped - rgb).abs().max()
                                          .detach())}
        for only in (False, True):
            worst, median, spread = sdf_leaf_errs(cfg, m, x, d, only)
            row["rgb_spread"] = spread
            row["rgb_only" if only else "full_loss"] = {
                "dropped_grad_cot_worst_leaf_err": worst,
                "median_leaf_err": median}
        print(json.dumps(row), flush=True)
    # K3-idr's replay at the scaled net against the plain op at the bf16
    # weights (the smoke's `signal` case of `check_k3`)
    m = scaled(model, chip_smoke.BG_SIGNAL_GAIN)
    xr, dr = x[:2048].contiguous(), d[:2048].contiguous()
    w = render_core.CoreWeights.of(m.implicit, m.rendering)
    st = render_core.CoreStages(cfg.implicit, cfg.rendering, w)
    k3 = emulate_render_core(st, xr, dr)
    rnd = lambda ts: tuple(t.detach().to(torch.bfloat16).float()  # noqa
                           for t in ts)
    wb = render_core.CoreWeights(rnd(w.ws_sdf), w.bs_sdf, rnd(w.ws_rad),
                                 w.bs_rad)
    ref = render_core.render_core_train_plain(cfg.implicit, cfg.rendering, wb,
                                              xr, dr)
    print(json.dumps({"k3_replay_vs_bf16w_at_signal_net": {
        k: float((a - b.detach()).abs().max())
        for k, a, b in zip(("sdf", "grad", "rgb"), k3, ref)}}), flush=True)
    # K4-idr's replay on a subsample of the smoke's training batch (32 of
    # its 1,600 rays, every 6th eikonal row), `signal_net` with the
    # gradient rows scaled by each gain, the rgb cotangent alone: its
    # gradients against the plain f32 backward as is, and with the
    # gradient columns' cotangent left out
    xb, db, S = chip_smoke.k4_batch(cfg, conf, torch.device("cpu"))
    rays = torch.arange(0, chip_smoke.K4_RAYS, 50)
    eik = torch.arange(xb.shape[0] - chip_smoke.K4_EIK, xb.shape[0], 6)
    idx = torch.cat([(rays[:, None] * S + torch.arange(S)).reshape(-1), eik])
    xb, db = xb[idx].contiguous(), db[idx].contiguous()
    init = render_core.K4Stages.__init__
    for gain in (1.0, 3.0, chip_smoke.IDR_GRAD_GAIN):
        m = copy.deepcopy(model)
        m.rendering = chip_smoke.signal_net(model.rendering)
        v = cfg.rendering.view_dim()
        with torch.no_grad():
            m.rendering.lin0.v[3 + v:6 + v] *= gain
        w = render_core.CoreWeights.of(m.implicit, m.rendering)
        outs = render_core.render_core_train_plain(
            cfg.implicit, cfg.rendering, w, xb, db)
        cot = chip_smoke.loss_cotangents(*outs, len(eik),
                                         chip_smoke.SEED + 5)
        cot[:, :4] = 0.0
        g3 = emulate_render_core(render_core.CoreStages(
            cfg.implicit, cfg.rendering, w), xb, db)[1]
        ref = plain_vjp(cfg.implicit, cfg.rendering, w, xb, db, cot)
        row = {"grad_rows_gain": gain, "points": len(idx)}
        for dropped in (False, True):
            def k4_init(self, *a, dropped=dropped, **k):
                init(self, *a, **k)
                if dropped:
                    self.wgr.zero_()
            render_core.K4Stages.__init__ = k4_init
            try:
                got = [t for grp in emulate_bwd(cfg.implicit, cfg.rendering,
                                                w, xb, db, cot, grad=g3)
                       for t in grp]
            finally:
                render_core.K4Stages.__init__ = init
            row["dropped" if dropped else "replay"] = grad_check(
                got, ref, leaf_tol=math.inf, cos_tol=-1.0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
