"""The port's one-bounce indirect light (`i2sdf_tpu_torch/models/
indirect.py`) against the JAX package's (`i2sdf_tpu/models/indirect.py`)
on the CPU, on a narrow model whose JAX parameters (perturbed off the
geometric init, so the field is not a plain sphere) cross with
`params.py`: the sphere march, the field's radiance at its hits (nerf and
idr radiance nets), the irradiance estimate with emitters and ambient on
JAX's draws (`JaxDraws`), the smoothing and the chunked bake. atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import CfgNode as JNode
from i2sdf_tpu.models import indirect as jind
from i2sdf_tpu.models import mlp as jmlp
from i2sdf_tpu.models import renderer as jren
from i2sdf_tpu_torch.config import CfgNode as TNode
from i2sdf_tpu_torch.models import indirect as tind
from i2sdf_tpu_torch.models import mlp as tmlp
from i2sdf_tpu_torch.models import renderer as tren
from i2sdf_tpu_torch.params import from_jax_params
from test_torch_helpers import JaxDraws, perturbed

ATOL = 1e-4
MODEL = {
    "feature_vector_size": 16,
    "scene_bounding_sphere": 3.0,
    "implicit_network": {
        "d_in": 3, "d_out": 1, "dims": [32, 32, 32], "geometric_init": True,
        "bias": 0.8, "skip_in": [2], "weight_norm": True,
        "embed_type": "positional", "multires": 4},
    "rendering_network": {
        "mode": "nerf", "d_in": 3, "d_out": 3, "dims": [32],
        "weight_norm": True, "embed_type": "positional", "multires": 2},
    "density": {"params_init": {"beta": 0.1}, "beta_min": 1e-4},
    "ray_sampler": {"near": 0.0, "N_samples": 8, "N_samples_eval": 16,
                    "N_samples_extra": 4, "eps": 0.1, "beta_iters": 2,
                    "max_total_iters": 2},
}
CENTERS = np.array([[0.0, 1.2, 0.0], [1.0, -0.2, 0.4]], np.float32)
RADII = np.array([0.3, 0.25], np.float32)


def _pair(mode="nerf"):
    node = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in MODEL.items()}
    node["rendering_network"] = dict(
        MODEL["rendering_network"], mode=mode,
        d_in=9 if mode == "idr" else 3)
    jn = JNode({"model": node})
    jn.model.use_normal = False
    jcfg = jren.I2SDFConfig.from_cfgnode(jn.model)
    params = perturbed(jren.init(jax.random.PRNGKey(0), jcfg), 1)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tcfg = tren.I2SDFConfig.from_cfgnode(TNode({"model": node}).model)
    model = tren.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, params, model


def _rays(n=96, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _surface(seed=0, n=64):
    """Points near a unit sphere with their outward normals."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pts = (nrm * rng.uniform(0.95, 1.05, (n, 1))).astype(np.float32)
    return pts, nrm.astype(np.float32)


def test_sphere_trace_hit_matches_jax_on_analytic_and_net():
    o, d = _rays(128)

    def jsphere(p):
        return jnp.linalg.norm(p - jnp.asarray([0.0, 0.0, 2.5]), axis=-1) - 1.0

    def tsphere(p):
        return torch.linalg.norm(p - torch.tensor([0.0, 0.0, 2.5]),
                                 dim=-1) - 1.0

    o = o * 0.1
    jt, jh = jind.sphere_trace_hit(jsphere, jnp.asarray(o), jnp.asarray(d),
                                   8.0, n_steps=48)
    tt, th = tind.sphere_trace_hit(tsphere, torch.from_numpy(o),
                                   torch.from_numpy(d), 8.0, n_steps=48)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    assert 0 < int(th.sum()) < len(o)

    jcfg, params, model = _pair()
    o, d = _rays(128, 1)
    jt, jh = jind.sphere_trace_hit(
        lambda p: jmlp.sdf_vals(params["implicit"], jcfg.implicit, p
                                    )[:, 0], jnp.asarray(o), jnp.asarray(d),
        8.0, n_steps=24)
    tt, th = tind.sphere_trace_hit(
        lambda p: tmlp.sdf_vals(model.implicit, p)[:, 0],
        torch.from_numpy(o), torch.from_numpy(d), 8.0, n_steps=24)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)


@pytest.mark.parametrize("mode", ["nerf", "idr"])
def test_field_radiance_matches_jax(mode):
    jcfg, params, model = _pair(mode)
    o, d = _rays(96, 2)
    want = jind.make_field_radiance_fn(params, jcfg, n_steps=32)(
        jnp.asarray(o), jnp.asarray(d))
    got = tind.make_field_radiance_fn(model, n_steps=32)(
        torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert bool(got[1].any())


def _field_pair(mode="nerf", n_steps=24):
    jcfg, params, model = _pair(mode)
    return (jind.make_field_radiance_fn(params, jcfg, n_steps=n_steps),
            tind.make_field_radiance_fn(model, n_steps=n_steps))


@pytest.mark.parametrize("emitters", [False, True])
def test_indirect_irradiance_matches_jax(emitters):
    jfield, tfield = _field_pair()
    pts, nrm = _surface(3)
    key = jax.random.PRNGKey(4)
    kw = dict(spp=3, ambient=[0.1, 0.2, 0.3])
    jkw, tkw = dict(kw), dict(kw)
    if emitters:
        jkw.update(emitter_centers=jnp.asarray(CENTERS),
                   emitter_radii=jnp.asarray(RADII))
        tkw.update(emitter_centers=torch.from_numpy(CENTERS),
                   emitter_radii=torch.from_numpy(RADII))
    want = jind.indirect_irradiance(jfield, key, jnp.asarray(pts),
                                    jnp.asarray(nrm), **jkw)
    got = tind.indirect_irradiance(tfield, JaxDraws(key),
                                   torch.from_numpy(pts),
                                   torch.from_numpy(nrm), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.05


def test_smooth_irradiance_matches_jax():
    rng = np.random.default_rng(5)
    pts, nrm = _surface(5, n=300)
    e = rng.uniform(size=(300, 3)).astype(np.float32)
    for kw in (dict(), dict(k=5, radius=0.4, chunk=64)):
        np.testing.assert_allclose(
            tind.smooth_irradiance(pts, nrm, e, **kw),
            jind.smooth_irradiance(pts, nrm, e, **kw), atol=ATOL)
    qp, qn = _surface(6, n=50)
    np.testing.assert_allclose(
        tind.smooth_irradiance(pts, nrm, e, query_points=qp,
                               query_normals=qn, k=8),
        jind.smooth_irradiance(pts, nrm, e, query_points=qp,
                               query_normals=qn, k=8), atol=ATOL)


def test_bake_indirect_irradiance_matches_jax():
    """Three chunks, the last padded; emitters excluded; the log lines."""
    jfield, tfield = _field_pair(n_steps=16)
    pts, nrm = _surface(7, n=70)
    key = jax.random.PRNGKey(8)
    logs = []
    want = jind.bake_indirect_irradiance(
        jfield, key, pts, nrm, spp=2, emitter_centers=CENTERS,
        emitter_radii=RADII, chunk=32)
    got = tind.bake_indirect_irradiance(
        tfield, JaxDraws(key), pts, nrm, spp=2, emitter_centers=CENTERS,
        emitter_radii=RADII, chunk=32, log=logs.append)
    assert got.shape == (70, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert logs == ["[indirect] baked 32/70 samples",
                    "[indirect] baked 70/70 samples"]
