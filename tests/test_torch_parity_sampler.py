"""K2 module (`i2sdf_tpu_torch/ops/kernels/sampler_round.py`,
`models/sampler.py`): one refinement round and the eval sampler, against
the JAX package on the same numpy inputs.

* vs the XLA function `sampler.round_update`: both f32, but the reference's
  `prefix_sum` is a hi/lo-split bf16 triangular matmul for rows of 128 or
  more (~1e-5 relative), the port's a sequential f32 cumsum. Betas agree
  to 1e-5 relative and samples to 1e-4 absolute on depths in [0, 6];
* vs the Pallas kernel `sampler_round_pallas` in interpret mode, with the
  JAX package's own kernel tolerances (tests/test_pallas_sampler.py);
* `error_bound_z_vals` end to end on the global-early-exit branch, both
  where every ray converges at once (the duplicate-sample, skipped-MLP
  path) and where none does.

The CUDA kernel is held to this plain version on the card in
tests/test_torch_gpu_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.models import sampler as jsampler
from i2sdf_tpu.ops.pallas.sampler_round import sampler_round_pallas
from i2sdf_tpu_torch.models import sampler as tsampler
from i2sdf_tpu_torch.ops.kernels import sampler_round

JCFG = jsampler.SamplerConfig(scene_bounding_sphere=3.0, N_samples=16,
                              N_samples_eval=32, N_samples_extra=8, eps=0.1,
                              beta_iters=6, max_total_iters=3, add_tiny=1e-6)
TCFG = tsampler.SamplerConfig(scene_bounding_sphere=3.0, N_samples=16,
                              N_samples_eval=32, N_samples_extra=8, eps=0.1,
                              beta_iters=6, max_total_iters=3, add_tiny=1e-6)


def _round_inputs(R=40, S=128, n_out=24, seed=0):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 6.0, (R, S)).astype(np.float32), axis=-1)
    # signed distance to a wall at depth 3, with noise
    sdf = (3.0 - z + 0.1 * rng.normal(size=(R, S))).astype(np.float32)
    beta = rng.uniform(0.05, 0.8, (R,)).astype(np.float32)
    u = np.sort(rng.uniform(0.0, 1.0, (R, n_out)).astype(np.float32), -1)
    return z, sdf, beta, u


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S", [97, 128, 480])
@pytest.mark.parametrize("final", [False, True])
def test_round_matches_xla_round_update(final, S):
    z, sdf, beta, u = _round_inputs(S=S)
    beta0 = np.float32(0.1)
    s_ref, b_ref = jax.jit(jsampler.round_update, static_argnums=(0, 6))(
        JCFG, z, sdf, beta, beta0, u, final)
    s, b = sampler_round.sampler_round(
        TCFG, *_torch(z, sdf, beta), torch.tensor(beta0), torch.from_numpy(u),
        final)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)


@pytest.mark.parametrize("final", [False, True])
def test_round_matches_pallas_interpret(final):
    z, sdf, beta, u = _round_inputs()
    s_ker, b_ker = sampler_round_pallas(
        z, sdf, beta, u, 0.1, beta_iters=JCFG.beta_iters, eps=JCFG.eps,
        add_tiny=JCFG.add_tiny, final=final, block_rows=8, interpret=True)
    s, b = sampler_round.sampler_round_plain(
        TCFG, *_torch(z, sdf, beta), torch.tensor(0.1), torch.from_numpy(u),
        final)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ker), rtol=2e-2,
                               atol=1e-3)
    diff = np.abs(s.numpy() - np.asarray(s_ker))
    assert np.quantile(diff, 0.99) < 0.08
    assert diff.max() < 0.5
    np.testing.assert_allclose(s.numpy().mean(-1),
                               np.asarray(s_ker).mean(-1), atol=0.02)


def _rays(n, hit: bool, seed=3):
    """Rays from z = -4 toward a sphere of radius 1 at the origin; `hit`
    aims them at its centre region, else they pass 2 units to the side."""
    rng = np.random.default_rng(seed)
    cam = np.zeros((n, 3), np.float32)
    cam[:, 2] = -4.0
    target = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    target[:, 2] = 0.0
    if not hit:
        target[:, 0] += 2.0
    d = target - cam
    return cam, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("case", ["all_converged", "unconverged"])
def test_error_bound_z_vals_global_exit(case):
    """The eval sampler end to end on an analytic sphere SDF. With rays that
    miss the sphere and a small beta0 every ray's error bound is below eps
    after round 0, so rounds 1.. emit leading-column duplicates and skip
    the SDF (one evaluation in all); rays into the sphere never converge
    (every round evaluates)."""
    hit = case == "unconverged"
    cam, dirs = _rays(24, hit)
    beta0 = np.float32(0.002 if not hit else 0.01)
    jcfg = jsampler.SamplerConfig(
        scene_bounding_sphere=3.0, N_samples=16, N_samples_extra=8,
        eps=0.1, beta_iters=8, max_total_iters=4, add_tiny=1e-6,
        round_eval_counts=(32, 24, 16, 16))
    tcfg = tsampler.SamplerConfig(
        scene_bounding_sphere=3.0, N_samples=16, N_samples_extra=8,
        eps=0.1, beta_iters=8, max_total_iters=4, add_tiny=1e-6,
        round_eval_counts=(32, 24, 16, 16))
    z_ref, _, _ = jax.jit(lambda d, c: jsampler.error_bound_z_vals(
        jcfg, lambda p: jnp.linalg.norm(p, axis=-1) - 1.0,
        jax.random.PRNGKey(0), d, c, beta0, training=False))(dirs, cam)
    calls = []

    def sdf_fn(p):
        calls.append(p.shape[0])
        return torch.linalg.norm(p, dim=-1) - 1.0

    z, z_bg = tsampler.error_bound_z_vals(tcfg, sdf_fn, *_torch(dirs, cam),
                                          torch.tensor(beta0))
    assert z_bg is None
    assert len(calls) == (4 if hit else 1), calls
    assert z.shape == z_ref.shape == (24, tcfg.total_fg_samples)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    if not hit:  # the duplicates are real: few distinct depths per ray
        assert max(len(np.unique(r)) for r in z.numpy()) < z.shape[1]


def test_extra_sample_index_matches_reference():
    for n in (97, 128, 416, 480, 640):
        ref = np.asarray(jnp.linspace(0, n - 1, 32).astype(jnp.int32))
        np.testing.assert_array_equal(
            tsampler.extra_sample_index(n, 32).numpy(), ref)

