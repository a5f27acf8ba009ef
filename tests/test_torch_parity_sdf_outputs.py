"""K10 module (`i2sdf_tpu_torch/ops/kernels/sdf_outputs.py`): the port's
`fused_sdf_outputs` on the CPU (its plain version, the tangent sweep in
f32) against the JAX package on the same parameters and points.

* vs the XLA function `mlp.sdf_outputs(..., returns_grad=True)`: both f32,
  so sdf, features and gradient agree to 1e-4;
* vs the Pallas op `fused_outputs.fused_sdf_outputs` in interpret mode (as
  `tests/test_pallas_outputs.py` runs it): that kernel multiplies bf16
  operands, so the JAX test's bounds apply (`test_pallas_outputs.py:39-49`:
  sdf 0.02, features 0.05, gradient atol 0.05 / rtol 0.08 and cosine >
  0.995 per point).

K10's replay (`replay.K10Replay`: the kernel's own rounding on its stage
images) is held to the Pallas op at the same bounds. The configs are the
JAX test's (SMALL, CLAMPED with no encoding and a bounding sphere,
NONGEO_PE) and SMALL at perturbed weights (init + 0.01
N(0, 1)): the geometric init zeroes the encoding's rows of layer 0 and of
the skip, which hides a fault in the tangents' layout, so there each of
three planted faults must fail the bounds. The CUDA kernel is held to this
plain version on the card in tests/test_torch_gpu_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.models.mlp import ImplicitNetConfig, implicit_net_init
from i2sdf_tpu.models.mlp import sdf_outputs as xla_sdf_outputs
from i2sdf_tpu.ops.pallas.fused_outputs import fused_sdf_outputs as jax_fused
from i2sdf_tpu_torch.ops.kernels import (render_core, replay, sdf_grad,
                                         sdf_outputs)
from test_torch_helpers import implicit_from_jax

SMALL = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
CLAMPED = ImplicitNetConfig(
    feature_vector_size=8, sdf_bounding_sphere=1.5,
    dims=(32, 32), geometric_init=False, embed_type=None)
NONGEO_PE = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64), skip_in=(2,), geometric_init=False,
    embed_type="positional", multires=4)
CASES = {"small": (SMALL, False), "clamped": (CLAMPED, False),
         "nongeo_pe": (NONGEO_PE, False), "small_perturbed": (SMALL, True)}
# the JAX test's bounds for its bf16 kernel, (atol, rtol)
PALLAS_TOLS = {"sdf": (0.02, 0.02), "feat": (0.05, 0.05),
               "grad": (0.05, 0.08)}


def perturbed(params):
    """init + 0.01 N(0, 1) on every leaf, seeded."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_unflatten(tree, [
        p + 0.01 * rng.normal(size=p.shape).astype(np.float32)
        for p in leaves])


def case(name, n=200):
    cfg, perturb = CASES[name]
    params = implicit_net_init(jax.random.PRNGKey(0), cfg)
    if perturb:
        params = perturbed(params)
    pts = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    return cfg, params, pts


@functools.lru_cache(maxsize=None)
def pallas_refs(name):
    """The Pallas op's (sdf, feat, grad) in interpret mode on `case(name)`,
    as numpy arrays (computed once a case)."""
    cfg, params, pts = case(name)
    return [np.asarray(r) for r in jax_fused(
        params, cfg, jnp.asarray(pts), block_rows=64, interpret=True)]


def port(cfg, params, pts):
    net = implicit_from_jax(params, cfg)
    with torch.no_grad():
        outs = sdf_outputs.fused_sdf_outputs(net, torch.from_numpy(pts))
    return [o.numpy() for o in outs]


def assert_pallas_close(outs, refs):
    for name, a, b in zip(("sdf", "feat", "grad"), outs, refs):
        atol, rtol = PALLAS_TOLS[name]
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)
    g, gr = outs[2], refs[2]
    cos = np.sum(gr * g, -1) / np.maximum(
        np.linalg.norm(gr, axis=-1) * np.linalg.norm(g, axis=-1), 1e-9)
    assert cos.min() > 0.995


@pytest.mark.parametrize("name", list(CASES))
def test_sdf_outputs_plain_matches_xla(name):
    cfg, params, pts = case(name)
    outs = port(cfg, params, pts)
    refs = jax.jit(lambda p, x: xla_sdf_outputs(p, cfg, x, returns_grad=True)
                   )(params, jnp.asarray(pts))
    for label, a, b in zip(("sdf", "feat", "grad"), outs, refs):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4,
                                   err_msg=label)


@pytest.mark.parametrize("name", list(CASES))
def test_sdf_outputs_plain_matches_pallas_interpret(name):
    cfg, params, pts = case(name)
    assert_pallas_close(port(cfg, params, pts), pallas_refs(name))


@pytest.mark.parametrize("name", list(CASES))
def test_k10_replay_matches_pallas_interpret(name):
    """K10 as it rounds (`replay.K10Replay` on its pack, `OutputStages`:
    K3's wgmma tangent form on the stage images, bf16 activations, f32
    sums, the clamp in its epilogue) against the Pallas op in interpret
    mode, within the JAX test's bounds for its bf16 kernel."""
    cfg, params, pts = case(name)
    net = implicit_from_jax(params, cfg)
    lins = net.layers()
    with torch.no_grad():
        k = sdf_outputs.OutputStages(net.cfg, [l.weight() for l in lins],
                                     [l.b for l in lins])
        got = replay.emulate_sdf_outputs(k, net.cfg, torch.from_numpy(pts))
    assert_pallas_close([t.numpy() for t in got], pallas_refs(name))


def test_flagship_perturbed_matches_pallas_interpret():
    """The flagship net at perturbed weights (the `gpu` tests' net, v +
    0.01 N(0, 1), bounding sphere 4) at 4,800 eikonal points: the port's
    plain op against the Pallas op within the JAX test's bounds, with the
    per-point cosine held where XLA's gradient norm is at least 0.5 (the
    `gpu` tests' and the smoke's TAN_COS_MIN_NORM). Below that norm bf16's
    error can turn a short gradient past 0.995, and the Pallas op's own
    gradient does so here: that is the reference behaviour the rule
    encodes."""
    from test_torch_rev_replay import FLAGSHIP, eikonal_points, sdf_net
    net = sdf_net(**FLAGSHIP, sphere=4.0)
    x = eikonal_points(4800, 4800)
    params = {}
    for key, v in net.state_dict().items():
        lin, leaf = key.split(".")
        params.setdefault(lin, {})[leaf] = jnp.asarray(v.numpy())
    cfg = ImplicitNetConfig(
        feature_vector_size=256, sdf_bounding_sphere=4.0, dims=(256,) * 8,
        skip_in=(4,), bias=0.6, embed_type="positional", multires=6)
    pts = jnp.asarray(x.numpy())
    xla = [np.asarray(r) for r in jax.jit(lambda p, x: xla_sdf_outputs(
        p, cfg, x, returns_grad=True))(params, pts)]
    ker = [np.asarray(r) for r in jax_fused(params, cfg, pts, block_rows=512,
                                           interpret=True)]
    with torch.no_grad():
        outs = [o.numpy() for o in sdf_outputs.fused_sdf_outputs(net, x)]
    for label, a, b in zip(("sdf", "feat", "grad"), outs, xla):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=label)
    held = np.linalg.norm(xla[2], axis=-1) >= 0.5
    assert held.mean() > 0.9
    for a in (outs, xla):
        assert_pallas_close([o[held] for o in a], [k[held] for k in ker])
    for label, a, b in zip(("sdf", "feat", "grad"), outs, ker):
        atol, rtol = PALLAS_TOLS[label]
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=label)
    g, gk = xla[2], ker[2]
    cos = np.sum(g * gk, -1) / np.maximum(
        np.linalg.norm(g, axis=-1) * np.linalg.norm(gk, axis=-1), 1e-9)
    assert cos.min() < 0.995 and cos[held].min() > 0.995


def tangent_faults(icfg, x):
    """The encoding's tangents (for layer 0, for the skip) as three faulty
    layouts would give them: the sin and cos blocks swapped, the skip's
    dropped, the x and y axes swapped."""
    t = sdf_grad.embed_tangents(icfg, x)
    a, b = 3, 3 + 3 * icfg.multires
    swapped = torch.cat([t[..., :a], t[..., b:], t[..., a:b]], -1)
    return {"cos_sin_swapped": (swapped, swapped),
            "skip_tangents_dropped": (t, torch.zeros_like(t)),
            "axes_permuted": (t[[1, 0, 2]], t[[1, 0, 2]])}


@pytest.mark.parametrize("fault", ["cos_sin_swapped", "skip_tangents_dropped",
                                   "axes_permuted"])
def test_planted_tangent_fault_fails_at_perturbed_weights(fault):
    """The plain sweep fed one faulty tangent layout fails the bounds it
    is held to against the Pallas op, where the correct one passes."""
    cfg, params, pts = case("small_perturbed")
    refs = [np.asarray(r) for r in jax_fused(
        params, cfg, jnp.asarray(pts), block_rows=64, interpret=True)]
    net = implicit_from_jax(params, cfg)
    icfg, x = net.cfg, torch.from_numpy(pts)
    ws, bs = [l.weight() for l in net.layers()], [l.b for l in net.layers()]
    with torch.no_grad():
        out, grad = sdf_grad.sdf_tangents(
            icfg, ws, bs, x, *tangent_faults(icfg, x)[fault])
        sdf, grad = render_core._sphere_clamp(icfg, x, out[:, :1], grad)
    with pytest.raises(AssertionError):
        assert_pallas_close([sdf.numpy(), out[:, 1:].numpy(), grad.numpy()],
                            refs)


def test_fused_sdf_outputs_gives_no_gradient():
    """The op is forward only: with autograd tracking the net it raises;
    under no_grad its outputs are constants."""
    cfg, params, pts = case("small", n=8)
    net = implicit_from_jax(params, cfg)
    x = torch.from_numpy(pts)
    with pytest.raises(ValueError):
        sdf_outputs.fused_sdf_outputs(net, x)
    with torch.no_grad():
        outs = sdf_outputs.fused_sdf_outputs(net, x)
    assert not any(o.requires_grad for o in outs)
    empty = sdf_outputs.sdf_outputs_plain(net, x[:0])
    assert [tuple(o.shape) for o in empty] == [(0, 1), (0, 16), (0, 3)]
