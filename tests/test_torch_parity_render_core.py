"""K3 module (`i2sdf_tpu_torch/ops/kernels/render_core.py`): SDF, spatial
gradient and radiance at points, against the JAX package on the same
parameters and points.

* vs the XLA functions `mlp.sdf_outputs` + `mlp.rendering_net_apply`: both
  f32 (the gradient by autograd here, by `jax.vjp` there), agreement at
  f32 rounding (1e-5);
* vs the Pallas kernel `render_core_fused` in interpret mode, with the JAX
  package's own kernel tolerances (tests/test_pallas_train.py: sdf 0.02,
  grad 0.05 / rtol 0.08, rgb 0.03 / rtol 0.05), the kernel taking bf16
  operands.

The CUDA kernel is held to this plain version on the card in
tests/test_torch_gpu_kernels.py.
"""

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.models.mlp import (ImplicitNetConfig, RenderingNetConfig,
                                  implicit_net_init, rendering_net_apply,
                                  rendering_net_init, sdf_outputs)
from i2sdf_tpu.ops.pallas.fused_train import render_core_fused
from i2sdf_tpu_torch.ops.kernels import render_core
from test_torch_helpers import (implicit_from_jax, perturbed,
                                rendering_from_jax)
from test_torch_kernel_layout import emulate_render_core

ICFG = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
RCFG = RenderingNetConfig(
    feature_vector_size=16, mode="nerf", dims=(32, 32),
    embed_type="positional", multires=3)
ICFG_FLAG = ImplicitNetConfig(
    feature_vector_size=256, sdf_bounding_sphere=0.0, dims=(256,) * 8,
    skip_in=(4,), bias=0.6, embed_type="positional", multires=6)
RCFG_FLAG = RenderingNetConfig(
    feature_vector_size=256, mode="nerf", dims=(256,) * 4,
    embed_type="positional", multires=4)
TOLS = {"sdf": (0.02, 0.02), "grad": (0.05, 0.08), "rgb": (0.03, 0.05)}


def _setup(icfg, rcfg, n, seed=0, perturb=False):
    p_imp = implicit_net_init(jax.random.PRNGKey(seed), icfg)
    p_rad = rendering_net_init(jax.random.PRNGKey(seed + 1), rcfg)
    if perturb:
        p_imp, p_rad = perturbed(p_imp, seed + 10), perturbed(p_rad, seed + 11)
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pack = render_core.RenderCorePack(implicit_from_jax(p_imp, icfg),
                            rendering_from_jax(p_rad, rcfg))
    return p_imp, p_rad, pts, dirs, pack


@pytest.mark.parametrize("widths", ["small", "flagship"])
def test_plain_matches_xla(widths):
    icfg, rcfg = ((ICFG, RCFG) if widths == "small"
                  else (ICFG_FLAG, RCFG_FLAG))
    p_imp, p_rad, pts, dirs, pack = _setup(icfg, rcfg, 96)

    @jax.jit
    def ref(pi, pr, x, d):
        s, f, g = sdf_outputs(pi, icfg, x)
        return s, g, rendering_net_apply(pr, rcfg, x, g, d, f)

    sdf_r, grad_r, rgb_r = ref(p_imp, p_rad, pts, dirs)
    sdf, grad, rgb = render_core.render_core_fwd(
        pack, torch.from_numpy(pts), torch.from_numpy(dirs))
    for got, want in ((sdf, sdf_r), (grad, grad_r), (rgb, rgb_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_plain_matches_pallas_interpret():
    p_imp, p_rad, pts, dirs, pack = _setup(ICFG, RCFG, 96)
    ker = render_core_fused(p_imp, ICFG, p_rad, RCFG, pts, dirs,
                            block_rows=32, interpret=True)
    got = render_core.render_core_plain(pack.implicit, pack.rendering,
                                        torch.from_numpy(pts),
                                        torch.from_numpy(dirs))
    for name, g, k in zip(TOLS, got, ker):
        atol, rtol = TOLS[name]
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=atol,
                                   rtol=rtol, err_msg=name)



@pytest.mark.parametrize("weights", ["init", "perturbed"])
@pytest.mark.parametrize("widths", ["small", "flagship"])
def test_k3_replay_matches_pallas_interpret(widths, weights):
    """K3's four-stream replay on its stage images (the CUDA kernel's
    rounding and layout, tests/test_torch_kernel_layout.py) against the
    Pallas kernel's forward in interpret mode, at its tolerances (the
    tangent form rounds elsewhere than the TPU kernel's reverse sweep): at
    the init's weights and at weights perturbed by 0.01 N(0, 1)."""
    icfg, rcfg = ((ICFG, RCFG) if widths == "small"
                  else (ICFG_FLAG, RCFG_FLAG))
    p_imp, p_rad, pts, dirs, pack = _setup(icfg, rcfg, 64,
                                           perturb=weights == "perturbed")
    ker = render_core_fused(p_imp, icfg, p_rad, rcfg, pts, dirs,
                            block_rows=32, interpret=True)
    k = render_core.CoreStages(
        pack.implicit.cfg, pack.rendering.cfg,
        render_core.CoreWeights.of(pack.implicit, pack.rendering))
    got = emulate_render_core(k, torch.from_numpy(pts),
                              torch.from_numpy(dirs))
    for name, g, r in zip(TOLS, got, ker):
        atol, rtol = TOLS[name]
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol,
                                   rtol=rtol, err_msg=name)
