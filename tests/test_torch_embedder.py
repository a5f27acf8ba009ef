"""The port's input encodings (`i2sdf_tpu_torch/models/embedder.py`)
against the JAX package's (`i2sdf_tpu/models/embedder.py`), and the
radiance net's view encoding through a net config.

* spherical harmonics, degrees 1-5, on unit and non-unit directions:
  both f32 polynomials of the same constants, to 1e-6;
* Fourier features on the same (3, channels) matrix B (drawn in JAX from
  its key, handed to the port as numpy), to 1e-5 (sin and cos of
  arguments up to ~60 in f32);
* `get_embedder`'s dispatch and widths; the radiance config's
  `layer_dims` against the JAX config's for the SH view encoding (degree
  4 whatever `multires` says) and the idr input with and without
  `embed_point_multires`; Fourier refused through a config, with a
  message (the JAX config raises a KeyError there).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.models import embedder as jemb
from i2sdf_tpu.models.mlp import RenderingNetConfig as JRenderingNetConfig
from i2sdf_tpu_torch.models import embedder, mlp


def _dirs(n, seed, unit=True):
    x = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x


@pytest.mark.parametrize("unit", [True, False], ids=["unit", "raw"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_spherical_harmonics_matches_jax(degree, unit):
    x = _dirs(257, degree, unit)
    fn, dim = jemb.spherical_harmonics(degree)
    want = np.asarray(fn(x))
    got = embedder.spherical_harmonics(torch.from_numpy(x), degree)
    assert got.shape == (257, dim) == (257, embedder.sh_dim(degree))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    tfn, tdim = embedder.get_embedder("spherical_harmonics", degree=degree)
    assert tdim == dim
    assert torch.equal(tfn(torch.from_numpy(x)), got)


@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("channels,sigma", [(8, 1.0), (32, 3.0)])
def test_fourier_feature_matches_jax_on_the_same_matrix(channels, sigma,
                                                        include_input):
    key = jax.random.PRNGKey(channels)
    fn, dim = jemb.fourier_feature(key, channels, sigma,
                                   include_input=include_input)
    B = np.array(jax.random.normal(key, (3, channels)) * sigma)
    x = _dirs(129, channels, unit=False)
    want = np.asarray(fn(x))
    tfn, tdim = embedder.get_embedder("fourier", B=torch.from_numpy(B),
                                      include_input=include_input)
    got = tfn(torch.from_numpy(x))
    assert tdim == dim and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_get_embedder_dispatch():
    fn, dim = embedder.get_embedder("positional", multires=4)
    x = torch.from_numpy(_dirs(5, 0))
    assert dim == 27 and torch.equal(fn(x), embedder.positional_encoding(x, 4))
    assert embedder.get_embedder("spherical_harmonics", multires=10)[1] == 16
    with pytest.raises(ValueError, match="matrix B"):
        embedder.get_embedder("fourier", channels=8)
    with pytest.raises(ValueError):
        embedder.get_embedder("hash")


CONFIGS = {
    "nerf_pe": dict(mode="nerf", d_in=3, embed_type="positional"),
    "nerf_sh": dict(mode="nerf", d_in=3, embed_type="spherical_harmonics"),
    "idr_pe": dict(mode="idr", d_in=9, embed_type="positional"),
    "idr_pe_points": dict(mode="idr", d_in=9, embed_type="positional",
                          embed_point_multires=6),
    "idr_sh": dict(mode="idr", d_in=9, embed_type="spherical_harmonics"),
    "idr_none": dict(mode="idr", d_in=9, embed_type=None),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_radiance_layer_dims_match_jax(name):
    kw = dict(feature_vector_size=256, dims=(256,) * 4, multires=4,
              **CONFIGS[name])
    jcfg = JRenderingNetConfig(**kw)
    tcfg = mlp.RenderingNetConfig(**kw)
    assert tcfg.layer_dims() == jcfg.layer_dims()
    if name == "idr_pe":   # VolSDF's DTU radiance net
        assert tcfg.layer_dims()[0] == 289
    # the input the net builds has the width layer 0 takes
    d = torch.from_numpy(_dirs(4, 1))
    h = mlp.rendering_input(tcfg, d, torch.zeros(4, 256), d * 2, d * 3)
    assert h.shape == (4, tcfg.layer_dims()[0])


def test_fourier_view_encoding_is_refused_through_a_config():
    kw = dict(feature_vector_size=16, dims=(32,), embed_type="fourier")
    with pytest.raises(KeyError):
        JRenderingNetConfig(**kw).layer_dims()
    with pytest.raises(ValueError, match="fourier"):
        mlp.RenderingNetConfig(**kw)
    with pytest.raises(ValueError, match="SDF net"):
        mlp.ImplicitNetConfig(feature_vector_size=16, sdf_bounding_sphere=0.0,
                              embed_type="spherical_harmonics")
    with pytest.raises(ValueError, match="mode"):
        mlp.RenderingNetConfig(feature_vector_size=16, mode="pixel")


def test_idr_net_input_row_order_matches_jax():
    """The idr radiance net on the same parameters: [points (PE), view
    encoding, normals, features] in both packages' row order."""
    from i2sdf_tpu.models.mlp import rendering_net_apply, rendering_net_init
    from test_torch_helpers import rendering_from_jax
    for extra in ({}, {"embed_point_multires": 3},
                  {"embed_type": "spherical_harmonics"}):
        jcfg = JRenderingNetConfig(
            **{**dict(feature_vector_size=8, mode="idr", d_in=9,
                      dims=(16, 16), embed_type="positional", multires=2),
               **extra})
        p = rendering_net_init(jax.random.PRNGKey(3), jcfg)
        rng = np.random.default_rng(4)
        pts, nrm = (rng.normal(size=(33, 3)).astype(np.float32)
                    for _ in range(2))
        d = _dirs(33, 5)
        feat = rng.normal(size=(33, 8)).astype(np.float32)
        want = np.asarray(rendering_net_apply(p, jcfg, pts, nrm, d, feat))
        net = rendering_from_jax(p, jcfg)
        assert dataclasses.asdict(net.cfg)["mode"] == "idr"
        got = net(torch.from_numpy(d), torch.from_numpy(feat),
                  torch.from_numpy(pts), torch.from_numpy(nrm))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6,
                                   rtol=1e-5, err_msg=str(extra))
