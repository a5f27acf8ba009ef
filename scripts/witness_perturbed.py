"""The JAX package's own kernels at the smoke's perturbed weights, against
the f32 bound the port's kernels are gated on there. CPU only: the Pallas
kernels run in interpret mode.

    JAX_PLATFORMS=cpu python scripts/witness_perturbed.py \
        [k1 k3 k4 k3_light k4_light bg rev ...]

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
to bf16. `bg`: the NeRF++ background pair (`get_bg_core_op` through
`bg_core_fused`) at the smoke's perturbed background nets
(`chip_smoke.bg_nets`), its forward (K8's) over the smoke's training
batch (51,200 points) and eval chunk (384,000) against `CORE_TOLS`' sigma
and rgb bounds and the spread rule (`k8_errors`), its backward (K9's) over
the training batch with the smoke's loss cotangents (`grad_errors`).
`rev`: `get_rev_op` (K5's and K6's TPU kernels) at the smoke's perturbed
SDF net of the training config (`perturbed_net`, seed SEED + 10, as
`check_rev` takes it) and at its odd-depth net (`odd_nets`, seed SEED +
20: seven hidden layers), over the normal-off step's 4,800 eikonal points
and the 155,200 render points: its forward (K5's) against `rev_plain`
at the f32 weights and at the weights rounded to bf16 (`fwd`: the points
past `REV_TOLS` for the sdf, the features and the gradient), its
backward (K6's, `jax.vjp` of the op on the materialized weights) with
`rev_cotangents` (`grad_errors`, against the same two). Runs in chunks of
65,536 points; K3 takes about ten minutes.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import sys
import tempfile
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
from i2sdf_tpu.ops.pallas.fused_bg import bg_core_fused  # noqa: E402
from i2sdf_tpu.ops.pallas.fused_mlp import fused_sdf_mlp  # noqa: E402
from i2sdf_tpu.ops.pallas.fused_rev import get_rev_op  # noqa: E402
from i2sdf_tpu.ops.pallas.fused_train import (  # noqa: E402
    get_render_core_op, render_core_fused)
from i2sdf_tpu_torch.ops.kernels import (bg_core, render_core,  # noqa: E402
                                         rev, sdf_mlp)

CHUNK = 1 << 16
CPU = torch.device("cpu")


def jax_params(net, ws=None, bs=None) -> dict:
    """A port net's parameters as the JAX package's {lin: {v, g, b}}; with
    `ws` and `bs` (a net without weight norm) its {lin: {w, b}} at those
    weights and biases."""
    if ws is not None:
        return {f"lin{l}": {"w": jnp.asarray(w.detach().numpy()),
                            "b": jnp.asarray(b.detach().numpy())}
                for l, (w, b) in enumerate(zip(ws, bs))}
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


def bg_weights(nets, bf16w: bool) -> bg_core.BgWeights:
    """The nets' materialized weights; with `bf16w` rounded to bf16 (the
    kernels' operands), biases as they are."""
    w = bg_core.BgWeights.of(*nets)
    if not bf16w:
        return w
    rnd = lambda ts: tuple(t.detach().to(torch.bfloat16).float()  # noqa
                           for t in ts)
    return bg_core.BgWeights(rnd(w.ws_i), w.bs_i, rnd(w.ws_r), w.bs_r)


def bg() -> list:
    conf = cs.bg_conf(train=False)
    cfg, model = cs.seeded_model(conf, CPU)
    with tempfile.TemporaryDirectory() as tmp:
        jcfg = jrenderer.I2SDFConfig.from_cfgnode(
            jax_load_cfg(cs.bg_conf_path(tmp)).model)
    icfg, rcfg = jcfg.bg_implicit, jcfg.bg_rendering
    nets = cs.bg_nets(model, cfg, CPU)["perturbed"]
    rows = []
    for label, n_rays in (("train", cs.K4_RAYS),
                          ("eval", conf.train.split_n_pixels)):
        x4, d = cs.bg_points(cfg, conf, CPU, n_rays)
        row = dict(op="forward", points=label, n=len(x4))
        for gate in ("f32", "bf16w"):
            w = bg_weights(nets, gate == "bf16w")
            pi, pr = (jax_params(m, ws, bs) for m, ws, bs in (
                (nets[0], w.ws_i, w.bs_i), (nets[1], w.ws_r, w.bs_r)))
            ker = [torch.cat(t) for t in zip(*(
                [torch.from_numpy(np.array(o)) for o in bg_core_fused(
                    pi, icfg, pr, rcfg, xc.numpy(), dc.numpy(),
                    block_rows=256, interpret=True)]
                for xc, dc in zip(x4.split(CHUNK), d.split(CHUNK))))]
            with torch.no_grad():
                ref = bg_core.bg_core_plain(cfg.bg_implicit, cfg.bg_rendering,
                                            w, x4, d)
            errs, ok = cs.k8_errors(ker, ref)
            row[gate] = dict(errs, ok=ok, past={
                k: past(a, b, *tol) for k, a, b, tol in zip(
                    ("sigma", "rgb"), ker, ref,
                    (cs.CORE_TOLS["sdf"], cs.CORE_TOLS["rgb"]))})
        rows.append(row)
    x4, d = cs.bg_points(cfg, conf, CPU, cs.K4_RAYS)
    row = dict(op="backward", points="train", n=len(x4))
    for gate in ("f32", "bf16w"):
        w0 = bg_weights(nets, gate == "bf16w")
        w = bg_core.BgWeights(*(tuple(t.detach().requires_grad_(True)
                                      for t in g)
                                for g in (w0.ws_i, w0.bs_i, w0.ws_r,
                                          w0.bs_r)))
        sigma, rgb = bg_core.bg_core_plain(cfg.bg_implicit, cfg.bg_rendering,
                                           w, x4, d)
        cot = cs.bg_cotangents(sigma, rgb, cs.SEED + 12)
        ref = torch.autograd.grad((sigma, rgb), w.flat(),
                                  (cot[:, :1], cot[:, 1:]))
        pi, pr = (jax_params(m, ws, bs) for m, ws, bs in (
            (nets[0], w.ws_i, w.bs_i), (nets[1], w.ws_r, w.bs_r)))
        got = None
        for sl in range(0, len(x4), CHUNK):
            xc = x4[sl:sl + CHUNK].numpy()
            dc = d[sl:sl + CHUNK].numpy()
            c = cot[sl:sl + CHUNK].numpy()
            _, vjp = jax.vjp(lambda a, b: bg_core_fused(
                a, icfg, b, rcfg, xc, dc, block_rows=256, interpret=True),
                pi, pr)
            gi, gr = vjp((jnp.asarray(c[:, :1]), jnp.asarray(c[:, 1:])))
            g = [torch.from_numpy(np.array(t[f"lin{l}"][leaf]))
                 for t, n, leaf in ((gi, len(w.ws_i), "w"),
                                    (gi, len(w.ws_i), "b"),
                                    (gr, len(w.ws_r), "w"),
                                    (gr, len(w.ws_r), "b"))
                 for l in range(n)]
            got = g if got is None else [a + b for a, b in zip(got, g)]
        row[gate] = cs.grad_errors(got, list(ref))
    rows.append(row)
    return rows


def rev_witness() -> list:
    conf = cs.train_conf()
    cfg, model = cs.seeded_model(conf, CPU)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(
        jax_load_cfg(str(cs.TRAIN_CONF)).model).implicit
    nets = {"perturbed": (cs.perturbed_net(model.implicit, cs.SEED + 10),
                          jcfg),
            "odd": (cs.odd_nets(cfg, CPU, cs.SEED + 20)[0],
                    dataclasses.replace(jcfg, dims=tuple(jcfg.dims[:-1])))}
    batches = (("eikonal", cs.eikonal_batch(cfg, conf, CPU, cs.SEED + 8)),
               ("render", cs.render_batch(cfg, conf, CPU)))
    rows = []
    for (case, (net, jc)), (label, x) in itertools.product(nets.items(),
                                                          batches):
        op = get_rev_op(jc, 256, True)
        lins = net.layers()
        ws = [l.weight().detach() for l in lins]
        bs = [l.b.detach() for l in lins]
        out_p, grad_p = rev.rev_plain(net.cfg, ws, bs, x)
        c_out, c_g = cs.rev_cotangents(out_p, grad_p, cs.SEED + 9)
        jw = (tuple(jnp.asarray(w.numpy()) for w in ws),
              tuple(jnp.asarray(b.numpy()) for b in bs))
        got, fwd = None, []
        for sl in range(0, len(x), CHUNK):
            xc = jnp.asarray(x[sl:sl + CHUNK].numpy())
            outs, vjp = jax.vjp(lambda w, b: op(w, b, xc), *jw)
            fwd.append([torch.from_numpy(np.array(t)) for t in outs])
            g = vjp((jnp.asarray(c_out[sl:sl + CHUNK].numpy()),
                     jnp.asarray(c_g[sl:sl + CHUNK].numpy())))
            g = [torch.from_numpy(np.array(t)) for grp in g for t in grp]
            got = g if got is None else [a + b for a, b in zip(got, g)]
        out_k, grad_k = (torch.cat(t) for t in zip(*fwd))
        row = dict(net=case, points=label, n=len(x), fwd={})
        for wl, bf16w in (("f32", False), ("bf16w", True)):
            wr = [(w.to(torch.bfloat16).float() if bf16w else w.clone()
                   ).requires_grad_() for w in ws]
            br = [b.clone().requires_grad_() for b in bs]
            out_r, grad_r = rev.rev_plain(net.cfg, wr, br, x)
            row["fwd"][wl] = {
                name: past(a, b.detach(), *cs.REV_TOLS[name])
                for name, a, b in (("sdf", out_k[:, :1], out_r[:, :1]),
                                   ("feat", out_k[:, 1:], out_r[:, 1:]),
                                   ("grad", grad_k, grad_r))}
            ref = torch.autograd.grad((out_r, grad_r), wr + br, (c_out, c_g))
            row[wl] = cs.grad_errors(got, list(ref))
        rows.append(row)
    return rows


WITNESSES = {
    "k1": k1, "k3": k3, "k4": k4,
    "k3_light": lambda: k3(cs.LIGHT_CONF),
    "k4_light": lambda: [k4(cs.LIGHT_CONF, d) for d in (True, False)],
    "bg": bg,
    "rev": rev_witness,
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
