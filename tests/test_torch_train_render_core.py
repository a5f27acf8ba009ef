"""The plain backward of the render core's training op
(`render_core_train_plain` + autograd, `ops/kernels/render_core.py`)
against the JAX package, on the same parameters, points and cotangents.
K4 itself is replayed in `test_torch_bwd_replay.py` and run on the card in
`test_torch_gpu_kernels.py`.

* Against `jax.vjp` of the XLA functions `mlp.sdf_outputs` +
  `mlp.rendering_net_apply`, both f32: every parameter leaf (v, g, b of
  both nets) to 1e-4 of its largest entry (f32 sums in another order).
* Against `jax.vjp` of the Pallas op `render_core_fused` in interpret
  mode, whose operands are bf16: cosine > 0.999 over all leaves (the JAX
  package's bound for its kernel, `tests/test_pallas_train.py:96-111`),
  and per leaf no further from the kernel than the JAX package's own f32
  XLA gradient is (max|d|/max|ref|, plus 1e-3). The JAX package's
  per-leaf bound of 0.1 holds against its bf16-compute XLA path; against
  an f32 reference its kernel test notes ~0.25 at these widths (bf16
  noise through the ReLU masks), and here the f32 XLA gradient itself is
  0.13 from the kernel on its worst leaf.
"""

import jax
import numpy as np
import torch

from i2sdf_tpu.models.mlp import (ImplicitNetConfig, RenderingNetConfig,
                                  implicit_net_init, rendering_net_apply,
                                  rendering_net_init, sdf_outputs)
from i2sdf_tpu.ops.pallas.fused_train import render_core_fused
from i2sdf_tpu_torch.ops.kernels import render_core
from test_torch_helpers import implicit_from_jax, rendering_from_jax

ICFG = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
RCFG = RenderingNetConfig(
    feature_vector_size=16, mode="nerf", dims=(32, 32),
    embed_type="positional", multires=3)


def _leaf_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)


def _cos(got: dict, ref: dict) -> float:
    a = np.concatenate([ref[k].ravel() for k in ref]).astype(np.float64)
    b = np.concatenate([got[k].ravel() for k in ref]).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _inputs(n, seed, eik=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cot = rng.normal(size=(n, 7)).astype(np.float32)
    if eik:  # eikonal rows: zero directions, only the gradient cotangent
        dirs[-eik:] = 0.0
        cot[-eik:, 3:] = 0.0
    return pts, dirs, cot


def _jax_setup(icfg, rcfg, seed=0):
    p_imp = implicit_net_init(jax.random.PRNGKey(seed), icfg)
    p_rad = rendering_net_init(jax.random.PRNGKey(seed + 1), rcfg)
    return p_imp, p_rad, implicit_from_jax(p_imp, icfg), rendering_from_jax(
        p_rad, rcfg)


def _port_vjp(net, rnet, pts, dirs, cot):
    """The plain backward: leaf name -> gradient."""
    w = render_core.CoreWeights.of(net, rnet)
    sdf, grad, rgb = render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, torch.from_numpy(pts), torch.from_numpy(dirs))
    c = torch.from_numpy(cot)
    names = ([f"implicit.{k}" for k, _ in net.named_parameters()]
             + [f"rendering.{k}" for k, _ in rnet.named_parameters()])
    leaves = list(net.parameters()) + list(rnet.parameters())
    gs = torch.autograd.grad((sdf, grad, rgb), leaves,
                             (c[:, 3:4], c[:, :3], c[:, 4:7]))
    return {k: g.numpy() for k, g in zip(names, gs)}


def _jax_grads_by_name(gp):
    out = {}
    for net in ("implicit", "rendering"):
        for lin, leaves in gp[net].items():
            for leaf, v in leaves.items():
                out[f"{net}.{lin}.{leaf}"] = np.asarray(v)
    return out


def _xla_vjp(p_imp, p_rad, pts, dirs, cot):
    def f(pi, pr):
        s, feat, g = sdf_outputs(pi, ICFG, pts)
        return g, s, rendering_net_apply(pr, RCFG, pts, g, dirs, feat)

    _, vjp = jax.vjp(f, p_imp, p_rad)
    gi, gr = vjp((cot[:, :3], cot[:, 3:4], cot[:, 4:7]))
    return _jax_grads_by_name({"implicit": gi, "rendering": gr})


def test_plain_backward_matches_xla_f32():
    p_imp, p_rad, net, rnet = _jax_setup(ICFG, RCFG)
    pts, dirs, cot = _inputs(96, 3)
    ref = _xla_vjp(p_imp, p_rad, pts, dirs, cot)
    got = _port_vjp(net, rnet, pts, dirs, cot)
    assert set(got) == set(ref)
    for k in ref:
        scale = max(np.abs(ref[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=k)


def test_plain_backward_matches_pallas_interpret():
    p_imp, p_rad, net, rnet = _jax_setup(ICFG, RCFG)
    pts, dirs, cot = _inputs(256, 4, eik=64)

    def f(pi, pr):
        s, g, rgb = render_core_fused(pi, ICFG, pr, RCFG, pts, dirs,
                                      block_rows=64, interpret=True)
        return g, s, rgb

    _, vjp = jax.vjp(f, p_imp, p_rad)
    gi, gr = vjp((cot[:, :3], cot[:, 3:4], cot[:, 4:7]))
    ker = _jax_grads_by_name({"implicit": gi, "rendering": gr})
    xla = _xla_vjp(p_imp, p_rad, pts, dirs, cot)
    got = _port_vjp(net, rnet, pts, dirs, cot)
    assert _cos(got, ker) > 0.999
    for k in ker:
        assert _leaf_err(got[k], ker[k]) <= _leaf_err(xla[k], ker[k]) + 1e-3, k


def test_k4_replay_matches_pallas_interpret():
    """K4's replay (`test_torch_bwd_replay.emulate_bwd`: the CUDA kernel's
    stage images, ring table, scratch and bf16 rounding) against the
    Pallas op's backward in interpret mode, two bf16 kernels rounding in
    different places, with the cotangents of the JAX package's kernel-test
    loss at the plain outputs: that test's gradient check for its bf16
    kernel (`tests/test_pallas_train.py:81-111`: per leaf
    max|d|/max|ref| < 0.1, cosine > 0.999). The replay's gradients of the
    materialized weights reach v, g and b through the weight norm by
    autograd."""
    from test_torch_bwd_replay import emulate_bwd, loss_cotangents
    p_imp, p_rad, net, rnet = _jax_setup(ICFG, RCFG)
    pts, dirs, _ = _inputs(256, 4, eik=64)
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    w = render_core.CoreWeights.of(net, rnet)
    cot = loss_cotangents(*render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, x, d))
    cot[-64:, 3:] = 0.0   # eikonal rows: only the gradient's cotangent
    c = cot.numpy()

    def f(pi, pr):
        s, g, rgb = render_core_fused(pi, ICFG, pr, RCFG, pts, dirs,
                                      block_rows=64, interpret=True)
        return g, s, rgb

    _, vjp = jax.vjp(f, p_imp, p_rad)
    gi, gr = vjp((c[:, :3], c[:, 3:4], c[:, 4:7]))
    ker = _jax_grads_by_name({"implicit": gi, "rendering": gr})
    rep = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, cot)
           for t in grp]
    names = ([f"implicit.{k}" for k, _ in net.named_parameters()]
             + [f"rendering.{k}" for k, _ in rnet.named_parameters()])
    leaves = list(net.parameters()) + list(rnet.parameters())
    gs = torch.autograd.grad(w.flat(), leaves, rep)
    got = {k: g.numpy() for k, g in zip(names, gs)}
    assert _cos(got, ker) > 0.999
    for k in ker:
        assert _leaf_err(got[k], ker[k]) < 0.1, k
