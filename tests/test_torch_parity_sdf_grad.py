"""K11/K12 module (`i2sdf_tpu_torch/ops/kernels/sdf_grad.py`): the port's
plain op (`sdf_outputs_fused_grad` on the CPU) and its tangent sweep
(`sdf_tangents`) against the JAX package on the same parameters and
points, values and parameter gradients of `test_pallas_grad.py::
_loss_terms` (sdf, features and the gradient, so both cotangents of the
op are non-zero).

* vs `jax.grad` of the XLA function `mlp.sdf_outputs(..., returns_grad=
  True)`: both f32, so values agree to 1e-4 and gradients (second order
  included) to 1e-4 of each leaf's largest entry;
* vs the Pallas op `fused_grad.sdf_outputs_fused_grad` in interpret mode
  (96 points, `block_rows=32`, as `tests/test_pallas_grad.py` runs it):
  it multiplies bf16 operands, so the JAX test's value bounds (sdf 0.02,
  features 0.05, gradient 0.05 / rtol 0.08) and the JAX package's bound
  for bf16 kernel gradients (per leaf max|d|/max|ref| < 0.1, cosine >
  0.999) apply;
* the clamped-sphere case of `test_pallas_grad.py:86-97`;
* at perturbed weights (init + 0.01 N(0, 1)), the tangent sweep fed a
  faulty tangent layout fails the gradient bound.

The CUDA kernels are held to this plain op on the card in
tests/test_torch_gpu_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.models.mlp import ImplicitNetConfig, implicit_net_init
from i2sdf_tpu.models.mlp import sdf_outputs as xla_sdf_outputs
from i2sdf_tpu.ops.pallas.fused_grad import sdf_outputs_fused_grad as jax_op
from i2sdf_tpu_torch.ops.kernels import render_core, sdf_grad
from test_pallas_grad import _loss_terms
from test_torch_helpers import implicit_from_jax, to_numpy
from test_torch_parity_rev import _torch_loss
from test_torch_parity_sdf_outputs import perturbed, tangent_faults

SMALL = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
FLAGSHIP = ImplicitNetConfig(
    feature_vector_size=256, sdf_bounding_sphere=0.0,
    dims=(256,) * 8, skip_in=(4,), bias=0.6,
    embed_type="positional", multires=6)
CLAMPED = ImplicitNetConfig(
    feature_vector_size=8, sdf_bounding_sphere=1.2,
    dims=(32, 32), geometric_init=False, embed_type=None)
CASES = {"small": (SMALL, False, 96, 0.8), "small_perturbed": (SMALL, True,
                                                             96, 0.8),
         "flagship_perturbed": (FLAGSHIP, True, 32, 3.0)}


def case(name):
    cfg, perturb, n, scale = CASES[name]
    params = implicit_net_init(jax.random.PRNGKey(0), cfg)
    if perturb:
        params = perturbed(params)
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    gt_n = rng.normal(size=(n, 3)).astype(np.float32)
    gt_n /= np.linalg.norm(gt_n, axis=-1, keepdims=True)
    return cfg, params, pts, gt_n


def port(params, cfg, pts, gt_n, fault=None):
    """Values, loss and parameter gradients of the port: the op on the CPU
    (its plain version), or with `fault` the tangent sweep fed that faulty
    tangent layout."""
    net = implicit_from_jax(params, cfg)
    x, g = torch.from_numpy(pts), torch.from_numpy(gt_n)
    if fault is None:
        outs = sdf_grad.sdf_outputs_fused_grad(net, x)
    else:
        lins = net.layers()
        out, grad = sdf_grad.sdf_tangents(
            net.cfg, [l.weight() for l in lins], [l.b for l in lins], x,
            *tangent_faults(net.cfg, x)[fault])
        sdf, grad = render_core._sphere_clamp(net.cfg, x, out[:, :1], grad)
        outs = (sdf, out[:, 1:], grad)
    loss = _torch_loss(*outs, g)
    loss.backward()
    grads = {name: p.grad.numpy() for name, p in net.named_parameters()}
    return [o.detach().numpy() for o in outs], float(loss.detach()), grads


def jax_side(fn, params, pts, gt_n):
    x, g = jnp.asarray(pts), jnp.asarray(gt_n)

    def loss(p):
        return _loss_terms(*fn(p, x), g)

    outs = jax.jit(fn)(params, x)
    v, grads = jax.jit(jax.value_and_grad(loss))(params)
    flat = {f"{lin}.{leaf}": np.asarray(a)
            for lin, leaves in to_numpy(grads).items()
            for leaf, a in leaves.items()}
    return [np.asarray(o) for o in outs], float(v), flat


def xla(cfg):
    return lambda p, x: xla_sdf_outputs(p, cfg, x, returns_grad=True)


def pallas(cfg, block_rows=32):
    return lambda p, x: jax_op(p, cfg, x, block_rows=block_rows,
                               interpret=True)


def grad_errors(grads, refs):
    errs = {k: np.abs(grads[k] - ref).max() / max(np.abs(ref).max(), 1e-3)
            for k, ref in refs.items()}
    a = np.concatenate([refs[k].ravel() for k in sorted(refs)])
    b = np.concatenate([grads[k].ravel() for k in sorted(refs)])
    return max(errs.values()), a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("name", list(CASES))
def test_sdf_grad_plain_matches_xla(name):
    cfg, params, pts, gt_n = case(name)
    outs, v, grads = port(params, cfg, pts, gt_n)
    r_outs, r_v, r_grads = jax_side(xla(cfg), params, pts, gt_n)
    for label, a, b in zip(("sdf", "feat", "grad"), outs, r_outs):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=label)
    assert v == pytest.approx(r_v, rel=1e-5)
    assert set(grads) == set(r_grads)
    for k, ref in r_grads.items():
        np.testing.assert_allclose(grads[k], ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-8),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["small", "small_perturbed"])
def test_sdf_grad_plain_matches_pallas_interpret(name):
    cfg, params, pts, gt_n = case(name)
    outs, v, grads = port(params, cfg, pts, gt_n)
    r_outs, r_v, r_grads = jax_side(pallas(cfg), params, pts, gt_n)
    for label, a, b, (atol, rtol) in zip(
            ("sdf", "feat", "grad"), outs, r_outs,
            ((0.02, 0.02), (0.05, 0.05), (0.05, 0.08))):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=label)
    assert v == pytest.approx(r_v, rel=5e-3)
    worst, cos = grad_errors(grads, r_grads)
    assert worst < 0.1 and cos > 0.999, (worst, cos)


def test_sdf_tangents_gradients_match_xla():
    """Autograd through the f32 tangent sweep (the plain version of K10
    and the sweep the faults below go through) gives XLA's second-order
    gradients."""
    cfg, params, pts, gt_n = case("small_perturbed")
    net = implicit_from_jax(params, cfg)
    x, g = torch.from_numpy(pts), torch.from_numpy(gt_n)
    lins = net.layers()
    out, grad = sdf_grad.sdf_tangents(net.cfg, [l.weight() for l in lins],
                                      [l.b for l in lins], x)
    _torch_loss(out[:, :1], out[:, 1:], grad, g).backward()
    _, _, r_grads = jax_side(xla(cfg), params, pts, gt_n)
    for k, p in net.named_parameters():
        ref = r_grads[k]
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-8),
                                   err_msg=k)


def test_clamped_sphere_grad():
    """Points outside the bounding sphere take its sdf and gradient, with
    no encoding (`test_pallas_grad.py:86-97`)."""
    params = implicit_net_init(jax.random.PRNGKey(3), CLAMPED)
    pts = np.asarray([[2.0, 0.0, 0.0], [0.1, 0.1, 0.0]], np.float32)
    net = implicit_from_jax(params, CLAMPED)
    sdf, _, grad = sdf_grad.sdf_outputs_fused_grad(net, torch.from_numpy(pts))
    s_ref, _, g_ref = jax.jit(xla(CLAMPED))(params, jnp.asarray(pts))
    np.testing.assert_allclose(sdf.detach().numpy(), s_ref, atol=1e-5)
    np.testing.assert_allclose(grad.detach().numpy(), g_ref, atol=1e-5)
    s_k, _, g_k = jax.jit(pallas(CLAMPED, block_rows=8))(params,
                                                      jnp.asarray(pts))
    np.testing.assert_allclose(sdf.detach().numpy(), s_k, atol=0.01)
    np.testing.assert_allclose(grad.detach().numpy(), g_k, atol=0.02)
    np.testing.assert_allclose(grad[0].detach().numpy(), [-1.0, 0.0, 0.0])


@pytest.mark.parametrize("fault", ["cos_sin_swapped", "skip_tangents_dropped",
                                   "axes_permuted"])
def test_planted_tangent_fault_fails_at_perturbed_weights(fault):
    """The parameter gradients through a faulty tangent layout fail the
    bound the kernels are held to, where the plain op's pass it."""
    cfg, params, pts, gt_n = case("small_perturbed")
    _, _, r_grads = jax_side(xla(cfg), params, pts, gt_n)
    _, _, grads = port(params, cfg, pts, gt_n)
    worst, cos = grad_errors(grads, r_grads)
    assert worst < 0.1 and cos > 0.999
    _, _, bad = port(params, cfg, pts, gt_n, fault)
    worst, cos = grad_errors(bad, r_grads)
    assert worst >= 0.1 or cos <= 0.999, (worst, cos)


@pytest.mark.parametrize("points", ["eikonal", "render"])
def test_pallas_op_is_past_the_f32_bound_at_perturbed_weights(points):
    """Why `chip_smoke.py` and the `gpu` tests hold K10/K11 at perturbed
    weights to the plain op at bf16-rounded weights. At the smoke's
    perturbed flagship net (`configs/synthetic_quality.yml`, seed 0, +
    0.01 N(0, 1)) and its K11 points (the eikonal batch's 4,800, the
    render batch's 155,200), the JAX package's own kernel,
    `get_sdf_outputs_op` in interpret mode, lands past the JAX bound for
    its tangent kernels against the f32 op (the smoke's `tangent_check`)
    at some points, and at fewer against the plain op at bf16 weights:
    most of the f32 gap is the weights' rounding, which any bf16 kernel
    pays. The counts print with `-s`; K11 on the card lands past the f32
    bound at a like count (the smoke's `vs_f32.points_past`)."""
    import chip_smoke as cs
    from i2sdf_tpu.config import load_cfg as jax_load_cfg
    from i2sdf_tpu.models import renderer as jrenderer
    from i2sdf_tpu.ops.pallas.fused_grad import get_sdf_outputs_op
    from i2sdf_tpu_torch.config import load_cfg
    from i2sdf_tpu_torch.models import renderer
    tcfg = renderer.I2SDFConfig.from_cfgnode(cs.train_conf().model)
    net = cs.perturbed_net(renderer.I2SDFModel(tcfg, seed=cs.SEED).implicit,
                           cs.SEED + 10)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(
        jax_load_cfg(str(cs.TRAIN_CONF)).model).implicit
    conf = load_cfg(str(cs.CONF))
    conf.dataset.data_dir, conf.dataset.scan_id = "synthetic_quality", 1
    cpu = torch.device("cpu")
    x = (cs.eikonal_batch(tcfg, conf, cpu, cs.SEED + 8) if points == "eikonal"
         else cs.render_batch(tcfg, conf, cpu))
    with torch.no_grad():
        ws, bs = cs.net_weights(net)
        out, grad = get_sdf_outputs_op(jcfg, 128, True)(
            tuple(jnp.asarray(w.numpy()) for w in ws),
            tuple(jnp.asarray(b.numpy()) for b in bs), jnp.asarray(x.numpy()))
        out, grad = (torch.from_numpy(np.array(t)) for t in (out, grad))
        got = (out[:, :1], out[:, 1:], grad)
        past = {ref: cs.tangent_check(
            got, cs.sweep_outputs(net, x, False, bf16w=ref == "bf16w"), x,
            net.cfg, False)[0]["points_past"] for ref in ("f32", "bf16w")}
    print(f"\n{points}: {x.shape[0]} points, the Pallas op past the bound "
          f"at {past}")
    assert past["f32"] >= 1
    assert past["bf16w"] < past["f32"]


@pytest.mark.parametrize("name", ["small", "small_perturbed"])
def test_k12_replay_matches_pallas_interpret(name):
    """K12 is K6 on K6's pack (`sdf_grad.bwd_stages`): K6's replay as it
    rounds (`replay.emulate_rev_bwd`) on that pack, against the backward
    of the JAX package's `get_sdf_outputs_op` in interpret mode on the
    same points, weights and cotangents (a loss that reads the sdf, the
    features and the gradient), within the JAX package's bound for bf16
    kernel gradients (per leaf max|d|/max|ref| < 0.1, cosine > 0.999)."""
    from i2sdf_tpu.ops.pallas.fused_grad import get_sdf_outputs_op
    from i2sdf_tpu_torch.ops.kernels import replay, rev
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import loss_cotangents
    cfg, params, pts, _ = case(name)
    net = implicit_from_jax(params, cfg)
    lins = net.layers()
    ws = [lin.weight().detach() for lin in lins]
    bs = [lin.b.detach() for lin in lins]
    x = torch.from_numpy(pts)
    c_out, c_g = loss_cotangents(*rev.rev_plain(net.cfg, ws, bs, x))
    with torch.no_grad():
        got = [t for grp in replay.emulate_rev_bwd(
            sdf_grad.bwd_stages(net.cfg, ws, bs), x, c_out, c_g)
            for t in grp]
    op = get_sdf_outputs_op(cfg, 32, True)
    _, vjp = jax.vjp(lambda w, b: op(w, b, jnp.asarray(pts)),
                     tuple(jnp.asarray(w.numpy()) for w in ws),
                     tuple(jnp.asarray(b.numpy()) for b in bs))
    ref = [torch.from_numpy(np.array(t)) for grp in vjp(
        (jnp.asarray(c_out.numpy()), jnp.asarray(c_g.numpy()))) for t in grp]
    assert [g.shape for g in got] == [r.shape for r in ref]
    grad_check(got, ref)
