"""The render core with the light head beside the idr-mode radiance net
(`ops/kernels/render_core.py`: K3's `kLight` x `kIdr` instantiation and
K4's light sweep on its idr branch, counted as `render_core_fwd_light_idr`
and `render_core_bwd_light_idr`) against the JAX package, on the same
parameters and inputs (numpy seeded), for both `detach_light` values.

Nets: SDF 4 x 32 with a skip at 2, 16 features, radiance 2 x 32 in idr
mode ([points | PE(view) | normals | features], 43 inputs), light 16 ->
16 -> 1 on relu(features): the light-mask config with VolSDF's DTU
radiance net at a narrow width.

* The plain op (`render_core_plain`, `render_core_train_plain`) against
  the XLA composition (`mlp.sdf_outputs`, `rendering_net_apply` on the
  gradient, the light net on relu(features)), all f32: outputs to 1e-5
  relative and the gradient of a loss with a light term per leaf to 1e-4
  of the leaf's largest entry, as `test_torch_parity_light.py` holds the
  light head.
* The plain op against the Pallas op `render_core_fused(..., idr, lcfg,
  detach_light, interpret=True)`, bf16 operands, at the JAX package's
  bounds for the light kernel (`tests/test_pallas_train.py:171-176,
  198-204`): sdf 0.02 / rtol 0.02, grad 0.05 / 0.08, rgb 0.03 / 0.05,
  lmask 0.02 / 0.03, the loss to 2 % and each gradient leaf of the three
  nets to 0.35 of its largest entry; at the init's weights and at weights
  perturbed by 0.01 N(0, 1) (a swapped pts / grad pair passes at a
  sphere's init).
* K3-light-idr's replay (`test_torch_kernel_layout.emulate_render_core`)
  against the Pallas forward at those tolerances, and K4-light-idr's
  replay (`test_torch_bwd_replay.emulate_bwd`, handed K3's replayed
  gradient as the op hands K3's) against the Pallas backward: each leaf
  to 0.35 of its largest entry and cosine > 0.999 over all leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.models.mlp import (ImplicitNetConfig, RenderingNetConfig,
                                  implicit_net_apply, implicit_net_init,
                                  rendering_net_apply, rendering_net_init,
                                  sdf_outputs)
from i2sdf_tpu.ops.pallas.fused_train import render_core_fused
from i2sdf_tpu_torch.ops.kernels import render_core
from test_torch_helpers import (implicit_from_jax, perturbed,
                                rendering_from_jax)
from test_torch_kernel_layout import emulate_render_core
from test_torch_parity_light import _loss

ICFG = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0, dims=(32,) * 4,
    skip_in=(2,), bias=0.6, embed_type="positional", multires=4)
RCFG = RenderingNetConfig(feature_vector_size=16, mode="idr", d_in=9,
                          dims=(32, 32), embed_type="positional", multires=3)
LCFG = ImplicitNetConfig(
    feature_vector_size=0, sdf_bounding_sphere=0.0, d_in=16, d_out=1,
    dims=(16,), geometric_init=False, skip_in=(), embed_type=None,
    output_activation="sigmoid")
N = 96
OUT_TOLS = ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05), (0.02, 0.03))
LEAF_TOL = 0.35
DETACH = pytest.mark.parametrize("detach", [True, False],
                                 ids=["detached", "coupled"])
WEIGHTS = pytest.mark.parametrize("weights", ["init", "perturbed"])


def _setup(perturb=False, seed=0):
    rng = np.random.default_rng(seed)
    p_imp = implicit_net_init(jax.random.PRNGKey(seed), ICFG)
    p_rad = rendering_net_init(jax.random.PRNGKey(seed + 1), RCFG)
    p_l = implicit_net_init(jax.random.PRNGKey(seed + 7), LCFG)
    if perturb:
        p_imp, p_rad, p_l = (perturbed(p, 10 + i)
                             for i, p in enumerate((p_imp, p_rad, p_l)))
    pts = (rng.normal(size=(N, 3)) * 0.8).astype(np.float32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    gt = {"rgb": rng.uniform(size=(N, 3)).astype(np.float32),
          "n": rng.normal(size=(N, 3)).astype(np.float32),
          "lm": rng.uniform(size=(N, 1)).astype(np.float32)}
    gt["n"] /= np.linalg.norm(gt["n"], axis=-1, keepdims=True)
    nets = (implicit_from_jax(p_imp, ICFG), rendering_from_jax(p_rad, RCFG),
            implicit_from_jax(p_l, LCFG))
    assert nets[1].cfg.mode == "idr"
    return {"i": p_imp, "r": p_rad, "l": p_l}, nets, pts, dirs, gt


def _ref(ps, pts, dirs, detach):
    sdf, feat, grad = sdf_outputs(ps["i"], ICFG, pts, returns_grad=True)
    rgb = rendering_net_apply(ps["r"], RCFG, pts, grad, dirs, feat)
    lf = jax.nn.relu(feat)
    if detach:
        lf = jax.lax.stop_gradient(lf)
    return sdf, grad, rgb, implicit_net_apply(ps["l"], LCFG, lf)


def _kernel(ps, pts, dirs, detach):
    return render_core_fused(ps["i"], ICFG, ps["r"], RCFG, pts, dirs,
                             block_rows=32, interpret=True,
                             params_light=ps["l"], lcfg=LCFG,
                             detach_light=detach)


def _jax_value_and_grads(fn, ps, pts, dirs, gt, detach):
    v, g = jax.value_and_grad(
        lambda p: _loss(jnp, *fn(p, pts, dirs, detach), gt))(ps)
    return float(v), {f"{net}.{lin}.{leaf}": np.asarray(a)
                      for net in g for lin, leaves in g[net].items()
                      for leaf, a in leaves.items()}


def _leaves(nets):
    names, leaves = [], []
    for key, m in zip("irl", nets):
        for k, p in m.named_parameters():
            names.append(f"{key}.{k}")
            leaves.append(p)
    return names, leaves


def _port(nets, pts, dirs, gt, detach):
    net, rnet, lnet = nets
    w = render_core.CoreWeights.of(net, rnet, lnet)
    outs = render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, torch.from_numpy(pts), torch.from_numpy(dirs),
        lnet.cfg, detach)
    loss = _loss(torch, *outs, {k: torch.from_numpy(v)
                                for k, v in gt.items()})
    names, leaves = _leaves(nets)
    grads = torch.autograd.grad(loss, leaves)
    return (outs, float(loss.detach()),
            {k: g.numpy() for k, g in zip(names, grads)})


@DETACH
def test_plain_light_idr_matches_xla_f32(detach):
    ps, nets, pts, dirs, gt = _setup(perturb=True)
    ref = _ref(ps, pts, dirs, detach)
    outs, v, got = _port(nets, pts, dirs, gt, detach)
    for name, o, r in zip(("sdf", "grad", "rgb", "lmask"), outs, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    v_ref, g_ref = _jax_value_and_grads(_ref, ps, pts, dirs, gt, detach)
    assert v == pytest.approx(v_ref, rel=1e-5)
    assert set(got) == set(g_ref)
    for k, r in g_ref.items():
        scale = max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(got[k], r, atol=1e-4 * scale, rtol=0,
                                   err_msg=k)
    # every net's leaves move; detached, the light term reaches no SDF leaf
    assert all(np.abs(got[f"{n}.lin0.v"]).max() > 0 for n in "irl")
    _, _, base = _port(nets, pts, dirs, {**gt, "lm": np.zeros_like(gt["lm"])},
                       detach)
    sdf_same = all(np.allclose(got[k], base[k], rtol=0, atol=1e-7)
                   for k in got if k.startswith("i."))
    assert sdf_same == detach


@WEIGHTS
@DETACH
def test_plain_light_idr_matches_pallas_interpret(weights, detach):
    ps, nets, pts, dirs, gt = _setup(perturb=weights == "perturbed", seed=1)
    ker = _kernel(ps, pts, dirs, detach)
    outs, v, got = _port(nets, pts, dirs, gt, detach)
    for name, o, k, (atol, rtol) in zip(("sdf", "grad", "rgb", "lmask"),
                                        outs, ker, OUT_TOLS):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(k),
                                   atol=atol, rtol=rtol, err_msg=name)
    v_ker, g_ker = _jax_value_and_grads(_kernel, ps, pts, dirs, gt, detach)
    assert v == pytest.approx(v_ker, rel=0.02)
    assert set(g_ker) == set(got)
    for k, kv in g_ker.items():
        denom = max(np.abs(got[k]).max(), 1e-3)
        assert np.abs(kv - got[k]).max() / denom < LEAF_TOL, k


def test_plain_eval_light_idr_matches_xla():
    """The eval forward (`render_core_plain` with the light net, no
    gradient) against the XLA composition, and the same four outputs as
    the training op's."""
    ps, (net, rnet, lnet), pts, dirs, _ = _setup(perturb=True, seed=2)
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    got = render_core.render_core_plain(net, rnet, x, d, lnet)
    assert len(got) == 4
    for name, o, r in zip(("sdf", "grad", "rgb", "lmask"), got,
                          _ref(ps, pts, dirs, True)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    tr = render_core.render_core_train(net.cfg, rnet.cfg, w, x, d,
                                       lcfg=lnet.cfg)
    for a, b in zip(tr, got):
        torch.testing.assert_close(a.detach(), b, atol=1e-6, rtol=1e-6)


@WEIGHTS
def test_k3_light_idr_replay_matches_pallas_interpret(weights):
    """K3-light-idr's four-stream replay on its stage images (the light
    input in tile 1, the idr columns in tile 0) against the Pallas
    forward, at the tolerances above."""
    ps, (net, rnet, lnet), pts, dirs, _ = _setup(weights == "perturbed", 3)
    ker = _kernel(ps, pts, dirs, True)
    k = render_core.CoreStages(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet, lnet),
        lnet.cfg)
    assert k.idr and k.n_light == 2
    assert render_core._variant(k) == "_light_idr"
    got = emulate_render_core(k, torch.from_numpy(pts),
                              torch.from_numpy(dirs))
    for name, g, r, (atol, rtol) in zip(("sdf", "grad", "rgb", "lmask"),
                                        got, ker, OUT_TOLS):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol,
                                   rtol=rtol, err_msg=name)


@DETACH
def test_k4_light_idr_replay_matches_pallas_interpret(detach):
    """K4-light-idr's replay (the light head before the idr columns, the
    light's feature cotangent and idr's gradient cotangent each in its own
    staging) against the Pallas backward at the loss's cotangents, at
    perturbed weights: each leaf to 0.35 of its largest entry, cosine >
    0.999."""
    from test_torch_bwd_replay import emulate_bwd
    ps, nets, pts, dirs, gt = _setup(perturb=True, seed=4)
    net, rnet, lnet = nets
    _, g_ker = _jax_value_and_grads(_kernel, ps, pts, dirs, gt, detach)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    outs = [t.detach().requires_grad_(True) for t in
            render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d,
                                                lnet.cfg, detach)]
    cs, cg, cr, cm = torch.autograd.grad(
        _loss(torch, *outs, {k: torch.from_numpy(v) for k, v in gt.items()}),
        outs)
    cot = torch.cat([cg, cs, cr, cm], 1)
    st = render_core.CoreStages(net.cfg, rnet.cfg, w, lnet.cfg)
    g3 = emulate_render_core(st, x, d)[1]
    rep = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, cot,
                                    detach_light=detach, lcfg=lnet.cfg,
                                    grad=g3) for t in grp]
    names, leaves = _leaves(nets)
    gs = torch.autograd.grad(w.flat(), leaves, rep)
    got = {k: g.numpy() for k, g in zip(names, gs)}
    a = np.concatenate([g_ker[k].ravel() for k in g_ker]).astype(np.float64)
    b = np.concatenate([got[k].ravel() for k in g_ker]).astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
    for k in g_ker:
        denom = max(np.abs(got[k]).max(), 1e-3)
        assert np.abs(g_ker[k] - got[k]).max() / denom < LEAF_TOL, k
