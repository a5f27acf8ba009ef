"""The JAX package's own kernels at the smoke's perturbed weights, against
the f32 bound the port's kernels are gated on there. CPU only: the Pallas
kernels run in interpret mode.

    JAX_PLATFORMS=cpu python scripts/witness_perturbed.py \
        [k1 k3 k4 k3_light k4_light ...]

At `chip_smoke.py`'s perturbed nets (`perturbed_net` of the seeded init,
seeds SEED + 10 + i; the flagship's, and the light config's with
`_light`) and its full point sets: K1's `fused_sdf_mlp` over the smoke's
K1 points (round 0 of an eval chunk), K3's forward (`render_core_fused`)
over its eval chunk, and K4's backward (`jax.vjp` of
`get_render_core_op`, the materialized weights permuted as
`render_core_fused` permutes them; with the light head for both
`detach_light` values) over its K4 batch with the smoke's loss
cotangents. Prints one JSON line each: the points past the bound the smoke
gates K1 (0.02 + 0.02 |ref|) and K3 (`CORE_TOLS`) on, or K4's gradient
check (`grad_errors`, the gate: worst leaf < 0.1, cosine > 0.999),
against the plain f32 op and against the plain op at the weights rounded
to bf16. Runs in chunks of 65,536 points; K3 takes about ten minutes.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from i2sdf_tpu.config import load_cfg as jax_load_cfg  # noqa: E402
from i2sdf_tpu.models import renderer as jrenderer  # noqa: E402
from i2sdf_tpu.ops.pallas.fused_mlp import fused_sdf_mlp  # noqa: E402
from i2sdf_tpu.ops.pallas.fused_train import (  # noqa: E402
    get_render_core_op, render_core_fused)
from i2sdf_tpu_torch.ops.kernels import render_core, sdf_mlp  # noqa: E402

CHUNK = 1 << 16
CPU = torch.device("cpu")


def jax_params(net) -> dict:
    """A port net's parameters as the JAX package's {lin: {v, g, b}}."""
    out = {}
    for k, v in net.state_dict().items():
        lin, leaf = k.split(".")
        out.setdefault(lin, {})[leaf] = jnp.asarray(v.numpy())
    return out


def past(got, ref, atol, rtol) -> int:
    """Points (rows) with an entry past atol + rtol |ref|."""
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    return int(bad.reshape(bad.shape[0], -1).any(-1).sum())


def setup(conf_path, train: bool):
    """The smoke's config (eval or training) of the flagship or the light
    config, the port's and the JAX package's model configs, and the
    perturbed nets (implicit, rendering, light or None)."""
    if conf_path == cs.LIGHT_CONF:
        conf = cs.light_conf(train=train)
    else:
        conf = cs.train_conf() if train else cs.eval_conf()
    cfg, model = cs.seeded_model(conf, CPU)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(
        jax_load_cfg(str(conf_path)).model)
    nets = [None if m is None else cs.perturbed_net(m, cs.SEED + 10 + i)
            for i, m in enumerate((model.implicit, model.rendering,
                                   model.light))]
    return conf, cfg, jcfg, nets


def k1() -> dict:
    conf, cfg, jcfg, (net, _, _) = setup(cs.CONF, False)
    pts = cs.k1_points(cfg, conf, CPU)
    params = jax_params(net)
    ker = torch.cat([torch.from_numpy(np.array(fused_sdf_mlp(
        params, jcfg.implicit, c.numpy(), block_rows=1024, interpret=True)))
        for c in pts.split(CHUNK)])
    f32 = sdf_mlp.sdf_mlp_plain(net, pts)
    bfw = cs.bf16w_sdf(net, pts)
    return dict(points=len(pts), past_f32=past(ker, f32, 0.02, 0.02),
                past_bf16w=past(ker, bfw, 0.02, 0.02),
                max_abs_f32=float((ker - f32).abs().max()))


def k3(conf_path=cs.CONF) -> dict:
    conf, cfg, jcfg, (net, rnet, lnet) = setup(conf_path, False)
    x, dd = cs.eval_chunk_points(cfg, conf, CPU)
    pi, pr = jax_params(net), jax_params(rnet)
    light = {} if lnet is None else dict(params_light=jax_params(lnet),
                                         lcfg=jcfg.light)
    outs = []
    for xc, dc in zip(x.split(CHUNK), dd.split(CHUNK)):
        o = render_core_fused(pi, jcfg.implicit, pr, jcfg.rendering,
                              xc.numpy(), dc.numpy(), block_rows=256,
                              interpret=True, **light)
        outs.append([torch.from_numpy(np.array(t)) for t in o])
    ker = [torch.cat(t) for t in zip(*outs)]
    nets = (net, rnet, lnet)
    refs = {"f32": cs.core_plain(nets, x, dd),
            "bf16w": cs.core_plain(nets, x, dd, bf16w=True)}
    names = list(cs.CORE_TOLS)[:len(ker)]
    row = dict(points=len(x))
    for label, ref in refs.items():
        row[f"past_{label}"] = {k: past(a, b, *cs.CORE_TOLS[k])
                                for k, a, b in zip(names, ker, ref)}
        row[f"max_abs_{label}"] = {k: float((a - b).abs().max())
                                   for k, a, b in zip(names, ker, ref)}
    return row


def k4(conf_path=cs.TRAIN_CONF, detach_light=True) -> dict:
    conf, cfg, jcfg, (net, rnet, lnet) = setup(conf_path, True)
    x, d, _ = cs.k4_batch(cfg, conf, CPU)
    icfg, rcfg = jcfg.implicit, jcfg.rendering
    F = icfg.feature_vector_size
    vdim = rcfg.layer_dims()[0] - F
    perm_out = np.concatenate([np.arange(1, F + 1), [0]])
    perm_in = np.concatenate([np.arange(vdim, vdim + F), np.arange(vdim)])
    light = lnet is not None
    op = (get_render_core_op(icfg, rcfg, 256, True, lcfg=jcfg.light,
                             detach_light=detach_light) if light
          else get_render_core_op(icfg, rcfg, 256, True))

    def pallas(xc, dc, ws, bs, wr, br, *wl):
        ws = ws[:-1] + (ws[-1][:, perm_out],)
        bs = bs[:-1] + (bs[-1][perm_out],)
        wr = (wr[0][perm_in],) + wr[1:]
        grad, sdf, *rest = op(ws, bs, wr, br, *wl, xc, dc)
        return (sdf, grad, *rest)

    row = dict(points=len(x), detach_light=detach_light if light else None)
    rnd = lambda ts: tuple(  # noqa: E731
        t.detach().to(torch.bfloat16).float().requires_grad_() for t in ts)
    for label, bf16w in (("f32", False), ("bf16w", True)):
        w = render_core.CoreWeights.of(net, rnet, lnet)
        if bf16w:   # both sides at the weights rounded to bf16
            w = render_core.CoreWeights(rnd(w.ws_sdf), w.bs_sdf,
                                        rnd(w.ws_rad), w.bs_rad,
                                        rnd(w.ws_l), w.bs_l)
        lcfg = lnet.cfg if light else None
        outs = render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x,
                                                   d, lcfg, detach_light)
        cot = cs.loss_cotangents(*outs[:3], cs.K4_EIK, cs.SEED + 5,
                                 lmask=outs[3] if light else None)
        cots = (cot[:, 3:4], cot[:, :3], cot[:, 4:7], cot[:, 7:8])
        cots = cots[:len(outs)]
        ref = torch.autograd.grad(outs, w.flat(), cots)
        groups = [w.ws_sdf, w.bs_sdf, w.ws_rad, w.bs_rad]
        if light:
            groups += [w.ws_l, w.bs_l]
        jw = [tuple(jnp.asarray(t.detach().numpy()) for t in g)
              for g in groups]
        got = None
        for sl in range(0, len(x), CHUNK):
            xc = jnp.asarray(x[sl:sl + CHUNK].numpy())
            dc = jnp.asarray(d[sl:sl + CHUNK].numpy())
            c = [jnp.asarray(t[sl:sl + CHUNK].numpy()) for t in cots]
            _, vjp = jax.vjp(lambda *a: pallas(xc, dc, *a), *jw)
            g = [torch.from_numpy(np.array(t)) for grp in vjp(tuple(c))
                 for t in grp]
            got = g if got is None else [a + b for a, b in zip(got, g)]
        row[label] = cs.grad_errors(got, list(ref))
    return row


WITNESSES = {
    "k1": k1, "k3": k3, "k4": k4,
    "k3_light": lambda: k3(cs.LIGHT_CONF),
    "k4_light": lambda: [k4(cs.LIGHT_CONF, d) for d in (True, False)],
}


def main(argv) -> int:
    for name in argv or list(WITNESSES):
        t0 = time.time()
        rows = WITNESSES[name]()
        for row in rows if isinstance(rows, list) else [rows]:
            print(json.dumps({"kernel": name, **row,
                              "seconds": round(time.time() - t0, 1)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
