"""K7 module (`i2sdf_tpu_torch/ops/kernels/conv_check.py`): the per-ray
sampler's convergence flags, is the opacity error bound at beta0 at most
eps, against the JAX package on the same numpy inputs: its XLA check
(`sampler._d_star` + `sampler._get_error_bound`) and its Pallas kernel
`conv_check_pallas` in interpret mode.

Band rule: the three compute the bound in f32 with their sums in other
orders (the JAX prefix sums are hi/lo-split bf16 matmuls), so a ray
whose bound lies within rounding of eps may flip. Each ray's bound is
also computed in f64; flags must agree on every ray whose f64 bound is
more than 1e-4 relative away from eps, and those within that band must
be under 1 % of the rays (the count is reported).

The CUDA kernel is held to this plain version on the card in
tests/test_torch_gpu_kernels.py.
"""

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.models import sampler as jsampler
from i2sdf_tpu.ops.pallas.sampler_round import conv_check_pallas
from i2sdf_tpu_torch.models.sampler import SamplerConfig
from i2sdf_tpu_torch.ops.kernels import conv_check

EPS = 0.1
BAND = 1e-4


def conv_inputs(R, S, seed):
    """Rays toward walls at random depths, some through them and some
    short of them, with SDF slopes and noise that spread the bounds at
    beta0 over decades on both sides of eps."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 6.0, (R, S)), axis=-1)
    wall = rng.uniform(1.0, 8.0, (R, 1))
    slope = rng.uniform(0.3, 1.0, (R, 1))
    sdf = (wall - z) * slope + rng.uniform(0.0, 0.05, (R, 1)) * rng.normal(
        size=(R, S))
    return z.astype(np.float32), sdf.astype(np.float32)


def bound_f64(z, sdf, beta0):
    """The per-ray max error bound in f64 (`sampler.py:151-186`)."""
    z, s = z.astype(np.float64), sdf.astype(np.float64)
    a = np.diff(z, axis=-1)
    b, c = np.abs(s[:, :-1]), np.abs(s[:, 1:])
    first, second = a ** 2 + b ** 2 <= c ** 2, a ** 2 + c ** 2 <= b ** 2
    h = (a + b + c) / 2
    area = h * (h - a) * (h - b) * (h - c)
    tri = ~first & ~second & (b + c - a > 0)
    heron = np.nan_to_num(2 * np.sqrt(np.maximum(area, 0))
                          / np.maximum(a, 1e-12))
    d = (first & ~second) * b + second * c + heron * tri
    d = (np.sign(s[:, 1:]) * np.sign(s[:, :-1]) == 1) * d
    dens = (1 / beta0) * (0.5 + 0.5 * np.sign(s) * np.expm1(-np.abs(s)
                                                             / beta0))
    integral = np.cumsum(np.concatenate(
        [np.zeros_like(a[:, :1]), a * dens[:, :-1]], -1), -1)
    err = np.exp(-d / beta0) * a ** 2 / (4 * beta0 ** 2)
    bound = ((np.minimum(np.exp(np.cumsum(err, -1)), 1e6) - 1)
             * np.exp(-integral[:, :-1]))
    return bound.max(-1)


def xla_flags(z, sdf, beta0):
    def f(z, s):
        d_star, dists = jsampler._d_star(z, s)
        return jsampler._get_error_bound(beta0, s, z, dists, d_star) <= EPS
    return np.asarray(jax.jit(f)(z, sdf))


@pytest.mark.parametrize("S", [97, 128, 416])
def test_conv_check_matches_jax_under_the_band_rule(S):
    R = 64
    cfg = SamplerConfig(eps=EPS)
    counts = {"converged": 0, "unconverged": 0, "in_band": 0}
    for seed, beta0 in ((S, 0.02), (S + 1, 0.05), (S + 2, 0.2)):
        z, sdf = conv_inputs(R, S, seed)
        got = conv_check.conv_check(cfg, torch.from_numpy(z),
                                    torch.from_numpy(sdf),
                                    torch.tensor(beta0)).numpy()
        assert got.dtype == np.bool_ and got.shape == (R,)
        ref64 = bound_f64(z, sdf, beta0)
        truth = ref64 <= EPS
        outside = np.abs(ref64 - EPS) > BAND * EPS
        pallas = np.asarray(conv_check_pallas(z, sdf, np.float32(beta0),
                                              eps=EPS, block_rows=16,
                                              interpret=True))
        for name, ref in (("f64", truth), ("xla", xla_flags(z, sdf, beta0)),
                          ("pallas", pallas)):
            bad = np.nonzero((got != ref) & outside)[0]
            assert bad.size == 0, (name, S, beta0, bad, ref64[bad])
        counts["converged"] += int(got.sum())
        counts["unconverged"] += int((~got).sum())
        counts["in_band"] += int((~outside).sum())
    print(f"S={S}: {counts}")
    assert counts["in_band"] < 0.01 * 3 * R
    # the inputs exercise both flags
    assert counts["converged"] >= 10 and counts["unconverged"] >= 10
