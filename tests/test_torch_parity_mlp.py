"""K1 module (`i2sdf_tpu_torch/ops/kernels/sdf_mlp.py`, `models/mlp.py`):
the port's plain SDF MLP against the JAX package, on the same parameters.

* vs the XLA function `mlp.sdf_vals`: both f32, so agreement is at f32
  rounding (1e-5 on O(1) SDF values);
* vs the Pallas kernel `fused_sdf_mlp` in interpret mode: that kernel
  multiplies bf16 operands, so the JAX package's own kernel tolerance
  (atol = rtol = 0.02, tests/test_pallas_mlp.py) applies.

The CUDA kernel is held to this plain version on the card in
tests/test_torch_gpu_kernels.py.
"""

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.models.mlp import (ImplicitNetConfig, implicit_net_init,
                                  sdf_vals)
from i2sdf_tpu.ops.pallas.fused_mlp import fused_sdf_mlp
from i2sdf_tpu_torch.models import mlp as tmlp
from i2sdf_tpu_torch.ops.kernels import sdf_mlp
from test_torch_helpers import implicit_from_jax
from test_torch_kernel_layout import emulate_sdf_mlp

SMALL = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
FLAGSHIP = ImplicitNetConfig(
    feature_vector_size=256, sdf_bounding_sphere=0.0,
    dims=(256,) * 8, skip_in=(4,), bias=0.6,
    embed_type="positional", multires=6)
CLAMPED = ImplicitNetConfig(
    feature_vector_size=8, sdf_bounding_sphere=1.5,
    dims=(32, 32), geometric_init=False, embed_type=None)


def _points(n, seed=1):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * 1.5).astype(
        np.float32)


@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP, CLAMPED],
                         ids=["small", "flagship", "clamped"])
def test_plain_matches_xla_sdf_vals(cfg):
    params = implicit_net_init(jax.random.PRNGKey(0), cfg)
    pts = _points(300)
    ref = np.asarray(sdf_vals(params, cfg, pts))[:, 0]
    net = implicit_from_jax(params, cfg)
    got = sdf_mlp.sdf_mlp_nograd(sdf_mlp.SdfMlpPack(net),
                                 torch.from_numpy(pts))
    assert got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_plain_matches_pallas_interpret(cfg):
    params = implicit_net_init(jax.random.PRNGKey(0), cfg)
    pts = _points(256, seed=2)
    ker = np.asarray(fused_sdf_mlp(params, cfg, pts, block_rows=128,
                                   interpret=True))
    got = sdf_mlp.sdf_mlp_plain(implicit_from_jax(params, cfg),
                                torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ker, atol=0.02, rtol=0.02)


@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_k1_replay_matches_pallas_interpret(cfg):
    """K1's byte-level replay on its stage images (the CUDA kernel's
    rounding and layout, tests/test_torch_kernel_layout.py) against the
    Pallas kernel in interpret mode, at the JAX kernel's tolerance."""
    params = implicit_from_jax(implicit_net_init(jax.random.PRNGKey(0), cfg),
                               cfg)
    pts = _points(256, seed=2)
    ker = np.asarray(fused_sdf_mlp(implicit_net_init(jax.random.PRNGKey(0),
                                                     cfg),
                                   cfg, pts, block_rows=128, interpret=True))
    p = sdf_mlp.SdfMlpPack.__new__(sdf_mlp.SdfMlpPack)
    p.net, p.kernel = params, sdf_mlp.stage_chain(params)
    got = emulate_sdf_mlp(p, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ker, atol=0.02, rtol=0.02)


def test_geometric_init_is_a_sphere():
    """The port's own init (torch.Generator, not threefry) gives the same
    kind of net as the reference's: SDF ~ |x| - bias, off by about as much
    as the reference's own init is (the draws differ, not the law)."""
    cfg = tmlp.ImplicitNetConfig(
        feature_vector_size=16, sdf_bounding_sphere=0.0, dims=(64,) * 4,
        skip_in=(2,), bias=0.6, embed_type="positional", multires=4)
    x = _points(512, seed=4) * 0.3
    sphere = np.linalg.norm(x, axis=-1) - cfg.bias
    dev_jax = np.mean([np.abs(np.asarray(sdf_vals(implicit_net_init(
        jax.random.PRNGKey(s), SMALL), SMALL, x))[:, 0] - sphere).mean()
        for s in range(4)])
    dev = np.mean([float((tmlp.sdf_vals(tmlp.ImplicitNet(
        cfg, torch.Generator().manual_seed(s)), torch.from_numpy(x))[:, 0]
        - torch.from_numpy(sphere)).abs().mean()) for s in range(4)])
    assert dev < 1.5 * dev_jax + 0.01, (dev, dev_jax)
    net = tmlp.ImplicitNet(cfg, torch.Generator().manual_seed(3))
    lin0 = net.lin0.weight()
    assert torch.all(lin0[3:] == 0)  # PE channels start at zero
    again = tmlp.ImplicitNet(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(again.lin0.v, net.lin0.v)  # seeded


def test_sdf_outputs_gradient_matches_finite_differences():
    net = implicit_from_jax(implicit_net_init(jax.random.PRNGKey(5), SMALL),
                            SMALL).double()
    x = torch.from_numpy(_points(16, seed=6)).double()
    sdf, feat, grad = tmlp.sdf_outputs(net, x)
    assert feat.shape == (16, SMALL.feature_vector_size)
    h = 1e-6
    for d in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[d] = h
        fd = (tmlp.sdf_vals(net, x + e) - tmlp.sdf_vals(net, x - e)) / (2 * h)
        np.testing.assert_allclose(grad[:, d].numpy(), fd[:, 0].numpy(),
                                   atol=1e-6)

