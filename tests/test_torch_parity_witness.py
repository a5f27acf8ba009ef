"""The JAX package's own kernels at perturbed weights against the f32 bound
the port's kernels are gated on there, beside the port's replays of K1, K3
and K4 on the same inputs (a small version of
`scripts/witness_perturbed.py`, which runs the smoke's full point sets).

Nets at narrow widths (SDF 4 x 64 with a skip at 2, radiance 2 x 32, 16
features) with every parameter moved by 0.01 N(0, 1) off the JAX init;
256 points, 64 of them eikonal rows for the backward. Both the Pallas
kernels in interpret mode and the port's replays stay inside the f32
bound here:

* K1 (`fused_sdf_mlp`, `emulate_sdf_mlp`): |d| <= 0.02 + 0.02 |ref|;
* K3 (`render_core_fused`'s forward, `emulate_render_core`): the JAX
  kernel tolerances (sdf 0.02 / 0.02, grad 0.05 / 0.08, rgb 0.03 / 0.05);
* K4 (the Pallas op's backward, `emulate_bwd`): the JAX package's
  gradient check for its bf16 kernel on the materialized weights (per
  leaf max|d|/max|ref| < 0.1, cosine > 0.999).

At the smoke's flagship widths and point counts the script finds the
Pallas K3 past the f32 bound at a few points (the reason K3 is gated on
the plain op at bf16 weights there) and K1 and K4 inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from i2sdf_tpu.models.mlp import (ImplicitNetConfig, RenderingNetConfig,
                                  implicit_net_init, rendering_net_init)
from i2sdf_tpu.ops.pallas.fused_mlp import fused_sdf_mlp
from i2sdf_tpu.ops.pallas.fused_train import (get_render_core_op,
                                              render_core_fused)
from i2sdf_tpu_torch.ops.kernels import render_core, sdf_mlp
from test_torch_bwd_replay import emulate_bwd, grad_check, plain_vjp
from test_torch_helpers import (implicit_from_jax, perturbed,
                                rendering_from_jax)
from test_torch_kernel_layout import emulate_render_core, emulate_sdf_mlp

ICFG = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
RCFG = RenderingNetConfig(
    feature_vector_size=16, mode="nerf", dims=(32, 32),
    embed_type="positional", multires=3)
TOLS = {"sdf": (0.02, 0.02), "grad": (0.05, 0.08), "rgb": (0.03, 0.05)}
N, EIK = 256, 64


def _setup():
    p_imp = perturbed(implicit_net_init(jax.random.PRNGKey(0), ICFG), 10)
    p_rad = perturbed(rendering_net_init(jax.random.PRNGKey(1), RCFG), 11)
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(N, 3)) * 0.8).astype(np.float32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (p_imp, p_rad, implicit_from_jax(p_imp, ICFG),
            rendering_from_jax(p_rad, RCFG), pts, dirs)


def _inside(got, ref, atol, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    return bool((np.abs(got - ref) <= atol + rtol * np.abs(ref)).all())


def test_k1_pallas_and_replay_inside_f32_at_perturbed_weights():
    p_imp, _, net, _, pts, _ = _setup()
    ref = sdf_mlp.sdf_mlp_plain(net, torch.from_numpy(pts)).numpy()
    ker = fused_sdf_mlp(p_imp, ICFG, pts, block_rows=128, interpret=True)
    p = sdf_mlp.SdfMlpPack.__new__(sdf_mlp.SdfMlpPack)
    p.net, p.kernel = net, sdf_mlp.stage_chain(net)
    rep = emulate_sdf_mlp(p, torch.from_numpy(pts)).numpy()
    assert _inside(ker, ref, 0.02, 0.02)
    assert _inside(rep, ref, 0.02, 0.02)


def test_k3_pallas_and_replay_inside_f32_at_perturbed_weights():
    p_imp, p_rad, net, rnet, pts, dirs = _setup()
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    ref = render_core.render_core_plain(net, rnet, x, d)
    ker = render_core_fused(p_imp, ICFG, p_rad, RCFG, pts, dirs,
                            block_rows=32, interpret=True)
    rep = emulate_render_core(render_core.CoreStages(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet)), x, d)
    for (name, (atol, rtol)), r, k, e in zip(TOLS.items(), ref, ker, rep):
        assert _inside(k, r.detach(), atol, rtol), name
        assert _inside(e, r.detach(), atol, rtol), name


def test_k4_pallas_and_replay_inside_f32_at_perturbed_weights():
    _, _, net, rnet, pts, dirs = _setup()
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    d[N - EIK:] = 0.0
    rng = np.random.default_rng(4)
    cot = torch.from_numpy(rng.normal(size=(N, 7)).astype(np.float32))
    cot[N - EIK:, 3:] = 0.0
    w = render_core.CoreWeights.of(net, rnet)
    ref = plain_vjp(net.cfg, rnet.cfg, w, x, d, cot)
    # the Pallas op on the materialized weights, permuted as
    # `render_core_fused` permutes them
    F = ICFG.feature_vector_size
    vdim = RCFG.layer_dims()[0] - F
    perm_out = np.concatenate([np.arange(1, F + 1), [0]])
    perm_in = np.concatenate([np.arange(vdim, vdim + F), np.arange(vdim)])
    op = get_render_core_op(ICFG, RCFG, 64, True)

    def pallas(ws, bs, wr, br):
        ws = ws[:-1] + (ws[-1][:, perm_out],)
        bs = bs[:-1] + (bs[-1][perm_out],)
        wr = (wr[0][perm_in],) + wr[1:]
        grad, sdf, rgb = op(ws, bs, wr, br, jnp.asarray(pts),
                            jnp.asarray(d.numpy()))
        return sdf, grad, rgb

    jw = [tuple(jnp.asarray(t.detach().numpy()) for t in g)
          for g in (w.ws_sdf, w.bs_sdf, w.ws_rad, w.bs_rad)]
    _, vjp = jax.vjp(pallas, *jw)
    c = cot.numpy()
    ker = [torch.from_numpy(np.array(t)) for grp in
           vjp((c[:, 3:4], c[:, :3], c[:, 4:7])) for t in grp]
    rep = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, cot)
           for t in grp]
    grad_check(ker, ref)
    grad_check(rep, ref)
