"""The render core with the light head (`ops/kernels/render_core.py`,
plain f32 versions) against the JAX package, on the same parameters and
inputs (numpy seeded), for both `detach_light` values.

Nets: SDF 4 x 32 with a skip at 2, radiance 2 x 32, 16 features, light
16 -> 16 -> 1 (the light-mask config's shape at a narrow width).

* Against the XLA reference (`_ref_light` of `tests/test_pallas_train.py:
  139-148`: `mlp.sdf_outputs`, `rendering_net_apply`, the light net on
  relu(features)), all f32: outputs to 1e-5 relative (f32 rounding), and
  the gradient of a loss with a light term per leaf to 1e-4 of the leaf's
  largest entry (f32 sums in another order, through the second order).
* Against the Pallas op `render_core_fused(..., params_light, lcfg,
  detach_light, interpret=True)`, whose operands are bf16: the JAX
  package's own bounds for that kernel against its reference
  (`tests/test_pallas_train.py:171-176,198-204`): sdf 0.02 / rtol 0.02,
  lmask 0.02 / 0.03, rgb 0.03 / 0.05; the loss to 2% and each gradient
  leaf to 0.35 of its largest entry.
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

ICFG = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0, dims=(32,) * 4,
    skip_in=(2,), bias=0.6, embed_type="positional", multires=4)
RCFG = RenderingNetConfig(feature_vector_size=16, mode="nerf", dims=(32, 32),
                          embed_type="positional", multires=3)
LCFG = ImplicitNetConfig(
    feature_vector_size=0, sdf_bounding_sphere=0.0, d_in=16, d_out=1,
    dims=(16,), geometric_init=False, skip_in=(), embed_type=None,
    output_activation="sigmoid")
N = 96
DETACH = pytest.mark.parametrize("detach", [True, False],
                                 ids=["detached", "coupled"])


def _setup(perturb=False):
    rng = np.random.default_rng(0)
    p_imp = implicit_net_init(jax.random.PRNGKey(0), ICFG)
    p_rad = rendering_net_init(jax.random.PRNGKey(1), RCFG)
    p_l = implicit_net_init(jax.random.PRNGKey(7), LCFG)
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
    return {"i": p_imp, "r": p_rad, "l": p_l}, nets, pts, dirs, gt


def _ref_light(ps, pts, dirs, detach):
    sdf, feat, grad = sdf_outputs(ps["i"], ICFG, pts, returns_grad=True)
    rgb = rendering_net_apply(ps["r"], RCFG, pts, grad, dirs, feat)
    lf = jax.nn.relu(feat)
    if detach:
        lf = jax.lax.stop_gradient(lf)
    return sdf, grad, rgb, implicit_net_apply(ps["l"], LCFG, lf)


def _kernel_light(ps, pts, dirs, detach):
    return render_core_fused(ps["i"], ICFG, ps["r"], RCFG, pts, dirs,
                             block_rows=32, interpret=True,
                             params_light=ps["l"], lcfg=LCFG,
                             detach_light=detach)


def _loss(xp, sdf, grad, rgb, lm, gt):
    """The JAX light test's loss (`test_pallas_train.py:38-43,186-188`)
    in either framework (`xp` is jnp or torch)."""
    norm = (jnp.linalg.norm(grad, axis=-1, keepdims=True) if xp is jnp
            else torch.linalg.norm(grad, dim=-1, keepdim=True))
    normals = grad / xp.maximum(norm, xp.asarray(1e-9) if xp is jnp
                                else torch.tensor(1e-9))
    return (xp.mean(xp.abs(rgb - gt["rgb"])) + 0.2 * xp.mean(sdf ** 2)
            + 0.5 * xp.mean(xp.abs(1 - (normals * gt["n"]).sum(-1)))
            + 0.1 * xp.mean((norm[:, 0] - 1) ** 2)
            + 0.3 * xp.mean((lm - gt["lm"]) ** 2))


def _jax_value_and_grads(fn, ps, pts, dirs, gt, detach):
    def loss(p):
        return _loss(jnp, *fn(p, pts, dirs, detach), gt)

    v, g = jax.value_and_grad(loss)(ps)
    return float(v), {f"{net}.{lin}.{leaf}": np.asarray(a)
                      for net in g for lin, leaves in g[net].items()
                      for leaf, a in leaves.items()}


def _port_value_and_grads(nets, pts, dirs, gt, detach):
    net, rnet, lnet = nets
    w = render_core.CoreWeights.of(net, rnet, lnet)
    outs = render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, torch.from_numpy(pts), torch.from_numpy(dirs),
        lnet.cfg, detach)
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    loss = _loss(torch, *outs, tgt)
    names, leaves = [], []
    for key, m in zip("irl", nets):
        for k, p in m.named_parameters():
            names.append(f"{key}.{k}")
            leaves.append(p)
    grads = torch.autograd.grad(loss, leaves)
    return (outs, float(loss.detach()),
            {k: g.numpy() for k, g in zip(names, grads)})


@DETACH
def test_plain_light_matches_xla_f32(detach):
    ps, nets, pts, dirs, gt = _setup()
    ref = _ref_light(ps, pts, dirs, detach)
    outs, v, got = _port_value_and_grads(nets, pts, dirs, gt, detach)
    for name, o, r in zip(("sdf", "grad", "rgb", "lmask"), outs, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    v_ref, g_ref = _jax_value_and_grads(_ref_light, ps, pts, dirs, gt,
                                        detach)
    assert v == pytest.approx(v_ref, rel=1e-5)
    assert set(got) == set(g_ref)
    for k, r in g_ref.items():
        scale = max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(got[k], r, atol=1e-4 * scale, rtol=0,
                                   err_msg=k)
    light = [k for k in got if k.startswith("l.") and k.endswith(".v")]
    assert light and all(np.abs(got[k]).max() > 0 for k in light)
    # detached, the light term reaches no SDF leaf through the features
    _, _, base = _port_value_and_grads(
        nets, pts, dirs, {**gt, "lm": np.zeros_like(gt["lm"])}, detach)
    sdf_same = all(np.allclose(got[k], base[k], rtol=0, atol=1e-7)
                   for k in got if k.startswith("i."))
    assert sdf_same == detach


@DETACH
def test_plain_light_matches_pallas_interpret(detach):
    ps, nets, pts, dirs, gt = _setup()
    ker = _kernel_light(ps, pts, dirs, detach)
    outs, v, got = _port_value_and_grads(nets, pts, dirs, gt, detach)
    for name, o, k, (atol, rtol) in zip(
            ("sdf", "grad", "rgb", "lmask"), outs, ker,
            ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05), (0.02, 0.03))):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(k),
                                   atol=atol, rtol=rtol, err_msg=name)
    v_ker, g_ker = _jax_value_and_grads(_kernel_light, ps, pts, dirs, gt,
                                        detach)
    assert v == pytest.approx(v_ker, rel=0.02)
    for k, kv in g_ker.items():
        denom = max(np.abs(got[k]).max(), 1e-3)
        assert np.abs(kv - got[k]).max() / denom < 0.35, k


@DETACH
def test_k4_light_replay_matches_pallas_interpret(detach):
    """K4-light's replay (`test_torch_bwd_replay.emulate_bwd`: the CUDA
    kernel's stage images, ring table, scratch and bf16 rounding) against
    the Pallas op's backward with the light head in interpret mode, on the
    gradient of the loss with its light term: each leaf to 0.35 of its
    largest entry (the bound above) and cosine > 0.999 over all leaves.
    The replay's gradients of the materialized weights reach v, g and b
    through the weight norm by autograd."""
    from test_torch_bwd_replay import emulate_bwd
    ps, nets, pts, dirs, gt = _setup()
    net, rnet, lnet = nets
    _, g_ker = _jax_value_and_grads(_kernel_light, ps, pts, dirs, gt, detach)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    outs = [t.detach().requires_grad_(True) for t in
            render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d,
                                                lnet.cfg, detach)]
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    cs, cg, cr, cm = torch.autograd.grad(_loss(torch, *outs, tgt), outs)
    cot = torch.cat([cg, cs, cr, cm], 1)
    rep = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, cot,
                                    detach_light=detach, lcfg=lnet.cfg)
           for t in grp]
    names, leaves = [], []
    for key, m in zip("irl", nets):
        for k, p in m.named_parameters():
            names.append(f"{key}.{k}")
            leaves.append(p)
    gs = torch.autograd.grad(w.flat(), leaves, rep)
    got = {k: g.numpy() for k, g in zip(names, gs)}
    keys = [k for k in g_ker]
    a = np.concatenate([g_ker[k].ravel() for k in keys]).astype(np.float64)
    b = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
    for k in keys:
        denom = max(np.abs(got[k]).max(), 1e-3)
        assert np.abs(g_ker[k] - got[k]).max() / denom < 0.35, k


def test_plain_eval_light_matches_xla():
    """The eval forward (`render_core_plain` with the light net, no
    gradient) against the XLA reference."""
    ps, (net, rnet, lnet), pts, dirs, _ = _setup()
    got = render_core.render_core_plain(net, rnet, torch.from_numpy(pts),
                                        torch.from_numpy(dirs), lnet)
    ref = _ref_light(ps, pts, dirs, True)
    for name, o, r in zip(("sdf", "grad", "rgb", "lmask"), got, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("weights", ["init", "perturbed"])
def test_k3_light_replay_matches_pallas_interpret(weights):
    """K3-light's four-stream replay on its stage images (the CUDA
    kernel's rounding and layout, tests/test_torch_kernel_layout.py)
    against the Pallas kernel's forward with the light head in interpret
    mode, at its tolerances: at the init's weights and at weights
    perturbed by 0.01 N(0, 1)."""
    ps, (net, rnet, lnet), pts, dirs, _ = _setup(weights == "perturbed")
    ker = _kernel_light(ps, pts, dirs, True)
    k = render_core.CoreStages(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet, lnet),
        lnet.cfg)
    got = emulate_render_core(k, torch.from_numpy(pts),
                              torch.from_numpy(dirs))
    for name, g, r, (atol, rtol) in zip(
            ("sdf", "grad", "rgb", "lmask"), got, ker,
            ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05), (0.02, 0.03))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol,
                                   rtol=rtol, err_msg=name)


def test_light_head_refusals():
    """The kernels take the light heads the TPU op takes
    (`supports_render_core`); others are refused with a message."""
    ps, (net, rnet, lnet), _, _, _ = _setup()
    from i2sdf_tpu_torch.models import mlp
    bad = mlp.ImplicitNetConfig(**{**lnet.cfg.__dict__, "skip_in": (1,)})
    with pytest.raises(ValueError, match="light head"):
        render_core.check_light_net(net.cfg, bad)
    render_core.check_light_net(net.cfg, lnet.cfg)
