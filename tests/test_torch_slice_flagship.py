"""The port's eval render at the flagship widths of `configs/synthetic.yml`
(SDF 8x256, radiance 4x256, 256 features) against the JAX package on 32
rays of scan1, on the CPU; tolerances as in test_torch_slice.py."""

from test_torch_slice import render_rays_against_jax


def test_render_rays_matches_jax_flagship():
    render_rays_against_jax(narrow=False, n_rays=32)
