"""K5/K6 module (`i2sdf_tpu_torch/ops/kernels/rev.py`): the port's plain rev
op against the JAX package on the same parameters and points.

* vs the XLA function `mlp.sdf_outputs(..., returns_grad=True)`: both
  f32, so the values agree to 1e-4 and the parameter gradients (through
  the spatial gradient, second order included) to 1e-4 of each leaf's
  largest entry;
* vs the Pallas op `fused_rev.sdf_outputs_fused_rev` in interpret mode
  (as `tests/test_pallas_rev.py` runs it): that kernel multiplies bf16
  operands, so the JAX test's bounds apply to the values (sdf 0.02,
  features 0.05, grad 0.05 / rtol 0.08) and the JAX package's bound for
  bf16 kernel gradients to the parameter gradients (per leaf
  max|d|/max|ref| < 0.1, cosine > 0.999).

The loss is `test_pallas_rev.py::_loss_terms`, which reads the sdf, the
features and the gradient, so both cotangents of the op (`c_out` and
`c_g`) are non-zero. The CUDA kernels are held to this plain version on
the card in tests/test_torch_gpu_kernels.py. K6's bf16 replay
(`test_torch_rev_replay.RevReplay`, the order of K4's wgmma sweeps) is
held to the Pallas backward (`get_rev_op` in interpret mode) on the same
weights and cotangents, with the JAX package's bound for bf16 kernel
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.models.mlp import (ImplicitNetConfig, implicit_net_init,
                                  sdf_outputs)
from i2sdf_tpu.ops.pallas.fused_rev import get_rev_op, sdf_outputs_fused_rev
from i2sdf_tpu_torch.ops.kernels import rev
from test_pallas_rev import _loss_terms
from test_torch_helpers import implicit_from_jax, to_numpy

SMALL = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
FLAGSHIP = ImplicitNetConfig(
    feature_vector_size=256, sdf_bounding_sphere=0.0,
    dims=(256,) * 8, skip_in=(4,), bias=0.6,
    embed_type="positional", multires=6)


def _inputs(cfg, n, seed, scale):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1.0, 1.0, (n, 3)) * scale).astype(np.float32)
    gt_n = rng.normal(size=(n, 3)).astype(np.float32)
    gt_n /= np.linalg.norm(gt_n, axis=-1, keepdims=True)
    params = implicit_net_init(jax.random.PRNGKey(seed), cfg)
    # move off the init's zero encoding weights, as a trained net would
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * jax.random.normal(jax.random.PRNGKey(7),
                                               p.shape), params)
    return params, pts, gt_n


def _torch_loss(sdf, feat, grad, gt_n):
    nrm = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True),
                             min=1e-9)
    return ((sdf ** 2).mean() + 0.1 * (feat ** 2).mean()
            + 0.5 * (1 - (nrm * gt_n).sum(-1)).abs().mean()
            + 0.1 * ((torch.linalg.norm(grad, dim=-1) - 1) ** 2).mean())


def _port(params, cfg, pts, gt_n):
    net = implicit_from_jax(params, cfg)
    x, g = torch.from_numpy(pts), torch.from_numpy(gt_n)
    outs = rev.sdf_outputs_rev(net, x, plain=True)
    loss = _torch_loss(*outs, g)
    loss.backward()
    grads = {f"{name.split('.')[0]}.{name.split('.')[1]}":
             p.grad.numpy() for name, p in net.named_parameters()}
    return [o.detach().numpy() for o in outs], float(loss.detach()), grads


def _jax(fn, params, pts, gt_n):
    x, g = jnp.asarray(pts), jnp.asarray(gt_n)

    def loss(p):
        return _loss_terms(*fn(p, x), g)

    outs = jax.jit(fn)(params, x)
    v, grads = jax.jit(jax.value_and_grad(loss))(params)
    flat = {f"{lin}.{leaf}": np.asarray(a)
            for lin, leaves in to_numpy(grads).items()
            for leaf, a in leaves.items()}
    return [np.asarray(o) for o in outs], float(v), flat


def _xla(cfg):
    return lambda p, x: sdf_outputs(p, cfg, x, returns_grad=True)


def _pallas(cfg):
    return lambda p, x: sdf_outputs_fused_rev(p, cfg, x, block_rows=32,
                                              interpret=True)


@pytest.mark.parametrize("cfg,n,scale", [(SMALL, 96, 1.0),
                                         (FLAGSHIP, 32, 4.0)],
                         ids=["small", "flagship"])
def test_rev_plain_matches_xla(cfg, n, scale):
    params, pts, gt_n = _inputs(cfg, n, 0, scale)
    outs, v, grads = _port(params, cfg, pts, gt_n)
    r_outs, r_v, r_grads = _jax(_xla(cfg), params, pts, gt_n)
    for name, a, b in zip(("sdf", "feat", "grad"), outs, r_outs):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert v == pytest.approx(r_v, rel=1e-5)
    assert set(grads) == set(r_grads)
    for k, ref in r_grads.items():
        scale_ = max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(grads[k], ref, rtol=0,
                                   atol=1e-4 * scale_, err_msg=k)


def test_rev_plain_matches_pallas_interpret():
    params, pts, gt_n = _inputs(SMALL, 96, 0, 1.0)
    outs, v, grads = _port(params, SMALL, pts, gt_n)
    r_outs, r_v, r_grads = _jax(_pallas(SMALL), params, pts, gt_n)
    for name, a, b, (atol, rtol) in zip(
            ("sdf", "feat", "grad"), outs, r_outs,
            ((0.02, 0.02), (0.05, 0.05), (0.05, 0.08))):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)
    assert v == pytest.approx(r_v, rel=5e-3)
    errs = {k: np.abs(grads[k] - ref).max() / max(np.abs(ref).max(), 1e-3)
            for k, ref in r_grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < 0.1, (worst, errs[worst])
    a = np.concatenate([r_grads[k].ravel() for k in sorted(r_grads)])
    b = np.concatenate([grads[k].ravel() for k in sorted(r_grads)])
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


def test_k6_replay_matches_pallas_interpret():
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import emulate_rev_bwd, loss_cotangents
    params, pts, _ = _inputs(SMALL, 96, 0, 1.0)
    net = implicit_from_jax(params, SMALL)
    lins = net.layers()
    ws = [lin.weight().detach() for lin in lins]
    bs = [lin.b.detach() for lin in lins]
    x = torch.from_numpy(pts)
    c_out, c_g = loss_cotangents(*rev.rev_plain(net.cfg, ws, bs, x))
    with torch.no_grad():
        got = [t for grp in emulate_rev_bwd(rev.RevStages(net.cfg, ws, bs),
                                            x, c_out, c_g) for t in grp]
    op = get_rev_op(SMALL, 32, True)
    _, vjp = jax.vjp(lambda w, b: op(w, b, jnp.asarray(pts)),
                     tuple(jnp.asarray(w.numpy()) for w in ws),
                     tuple(jnp.asarray(b.numpy()) for b in bs))
    ref = [torch.from_numpy(np.array(t)) for grp in vjp(
        (jnp.asarray(c_out.numpy()), jnp.asarray(c_g.numpy()))) for t in grp]
    assert [g.shape for g in got] == [r.shape for r in ref]
    grad_check(got, ref)
