"""The port's BRDF library and shading layer (`i2sdf_tpu_torch/models/
brdf.py`, `rendering_layer.py`) against the JAX package's, on the CPU:
the same seeded numpy inputs into both, the samplers fed the uniforms
JAX draws from the same key, and `shade` / `shade_emitters` walking JAX's
key tree through `JaxDraws`. f32 at atol 1e-5, rtol 1e-4; the radical
inverse to the bit; `detach_sampling`'s gradient against `jax.grad`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.models import brdf as jb
from i2sdf_tpu.models import rendering_layer as jrl
from i2sdf_tpu_torch.models import brdf as tb
from i2sdf_tpu_torch.models import rendering_layer as trl
from i2sdf_tpu_torch.utils.draws import Draws
from test_torch_helpers import JaxDraws

ATOL, RTOL = 1e-5, 1e-4
N = 96


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed=0):
    """Normals on both hemispheres (n_z < 0 takes build_onb's other
    branch), view directions around them (some below the horizon),
    materials and roughness down to 0.02."""
    rng = np.random.default_rng(seed)
    n = _unit(rng.normal(size=(N, 3)))
    v = _unit(n + 0.9 * rng.normal(size=(N, 3)))
    l = _unit(n + 0.9 * rng.normal(size=(N, 3)))
    return dict(
        pts=rng.uniform(-1, 1, (N, 3)).astype(np.float32), n=n, v=v, l=l,
        kd=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        ks=rng.uniform(0, 0.4, (N, 3)).astype(np.float32),
        rough=rng.uniform(0.02, 1, N).astype(np.float32),
        cos=rng.uniform(-0.2, 1, N).astype(np.float32),
        metal=rng.uniform(0, 1, (N, 1)).astype(np.float32))


def _close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol, rtol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _both(name, *keys):
    x = _inputs()
    j = getattr(jb, name)(*(jnp.asarray(x[k]) for k in keys))
    t = getattr(tb, name)(*(torch.from_numpy(x[k]) for k in keys))
    return t, j


DETERMINISTIC = {
    "build_onb": ("n",), "to_local": ("v", "n"), "to_world": ("v", "n"),
    "metallic_to_kd_ks": ("kd", "metal"), "luminance": ("kd",),
    "ggx_ndf": ("cos", "rough"), "smith_g1": ("cos", "rough"),
    "smith_g2": ("cos", "cos", "rough"), "eval_lambert": ("kd",),
    "eval_disney_diffuse": ("kd", "rough", "cos", "cos", "cos"),
    "eval_ggx_specular": ("ks", "rough", "n", "v", "l"),
    "eval_brdf": ("kd", "ks", "rough", "n", "v", "l"),
    "pdf_cosine": ("n", "l"), "pdf_ggx_vndf": ("n", "v", "l", "rough"),
    "specular_event_probability": ("kd", "ks"),
    "combined_pdf": ("kd", "ks", "rough", "n", "v", "l"),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_functions_match_jax(name):
    _close(*_both(name, *DETERMINISTIC[name]))


def test_eval_brdf_disney_and_fresnel_branches_match_jax():
    x = _inputs(1)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = ("kd", "ks", "rough", "n", "v", "l")
    _close(tb.eval_brdf(*(t[k] for k in args), diffuse_model="disney"),
           jb.eval_brdf(*(j[k] for k in args), diffuse_model="disney"))
    # cos of lower rank than f0, and of the same rank
    _close(tb.fresnel_schlick(t["ks"], t["cos"]),
           jb.fresnel_schlick(j["ks"], j["cos"]))
    _close(tb.fresnel_schlick(t["ks"], t["cos"][:, None]),
           jb.fresnel_schlick(j["ks"], j["cos"][:, None]))


def test_radical_inverse_equals_jax_to_the_bit():
    rng = np.random.default_rng(2)
    i = np.concatenate([np.arange(1024), [0xFFFFFFFF, 0x80000000, 1 << 16],
                        rng.integers(0, 2 ** 32, 4096)]).astype(np.uint32)
    got = tb._radical_inverse_base2(torch.from_numpy(i.astype(np.int64)))
    want = np.asarray(jb._radical_inverse_base2(i))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _key(i):
    return jax.random.PRNGKey(100 + i)


def test_samplers_match_jax_on_jax_uniforms():
    x = _inputs(3)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    u = torch.from_numpy(np.array(jax.random.uniform(_key(0), (N, 2))))
    cos_half = np.where(np.arange(N) % 7 == 0, -1.0,
                        np.linspace(0.0, 0.999, N)).astype(np.float32)
    _close(tb.sample_uniform_cone(u, t["n"], torch.from_numpy(cos_half)),
           jb.sample_uniform_cone(_key(0), j["n"], jnp.asarray(cos_half)))
    _close(tb.sample_cosine_hemisphere(u, t["n"]),
           jb.sample_cosine_hemisphere(_key(0), j["n"]))
    _close(tb.sample_ggx_vndf(u, t["n"], t["v"], t["rough"]),
           jb.sample_ggx_vndf(_key(0), j["n"], j["v"], j["rough"]))
    for spp in (1, 5, 16):
        shift = torch.from_numpy(np.array(jax.random.uniform(_key(spp),
                                                             (2, N))))
        _close(tb.cosine_hemisphere_ld(shift, t["n"], spp),
               jb.cosine_hemisphere_ld(_key(spp), j["n"], spp))
    # the draw_* wrappers on JAX's key tree give the same
    _close(tb.draw_ggx_vndf(JaxDraws(_key(0)), t["n"], t["v"], t["rough"]),
           jb.sample_ggx_vndf(_key(0), j["n"], j["v"], j["rough"]))
    _close(tb.draw_cosine_hemisphere_ld(JaxDraws(_key(4)), t["n"], 4),
           jb.cosine_hemisphere_ld(_key(4), j["n"], 4))


def test_generator_draws_give_unit_directions_and_repeat():
    x = _inputs(4)
    n = torch.from_numpy(x["n"])
    a, pdf = tb.draw_cosine_hemisphere(Draws.seeded(7), n)
    b, _ = tb.draw_cosine_hemisphere(Draws.seeded(7), n)
    assert torch.equal(a, b)
    torch.testing.assert_close(torch.linalg.norm(a, dim=-1),
                               torch.ones(N), atol=1e-5, rtol=0)
    assert bool(((a * n).sum(-1) >= -1e-6).all()) and bool((pdf > 0).all())
    cone, cpdf = tb.draw_uniform_cone(Draws.seeded(8), n,
                                      torch.full((N,), 0.9))
    assert bool(((cone * n).sum(-1) >= 0.9 - 1e-5).all())
    torch.testing.assert_close(cpdf, torch.full((N,), 1 / (0.2 * np.pi)))


def _shade_inputs(seed):
    x = _inputs(seed)
    keys = ("pts", "n", "v", "kd", "ks", "rough")
    return ([jnp.asarray(x[k]) for k in keys],
            [torch.from_numpy(x[k]) for k in keys])


def _jax_li(p, d):
    return jnp.abs(d) * 0.5 + 0.1 * jnp.sin(3.0 * p)


def _torch_li(p, d):
    return d.abs() * 0.5 + 0.1 * torch.sin(3.0 * p)


@pytest.mark.parametrize("diffuse_model", ["lambert", "disney"])
def test_shade_matches_jax(diffuse_model):
    jargs, targs = _shade_inputs(5)
    for spp in (1, 6):
        jcfg = jrl.RenderingLayerConfig(spp=spp, diffuse_model=diffuse_model)
        tcfg = trl.RenderingLayerConfig(spp=spp, diffuse_model=diffuse_model)
        want = jrl.shade(jcfg, _key(spp), *jargs, _jax_li)
        got = trl.shade(tcfg, JaxDraws(_key(spp)), *targs, _torch_li)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])


EMITTERS = (np.array([[0.0, 1.5, 0.0], [0.3, 0.2, 0.1], [-1.0, -1.0, 2.0]],
                     np.float32),
            np.array([0.4, 0.5, 0.2], np.float32),
            np.array([[3.0, 2.0, 1.0], [1.0, 1.0, 1.0], [0.5, 2.0, 4.0]],
                     np.float32))


def _jax_vis(p, d, t):
    return (jnp.sin(7.0 * (p + t[:, None] * d)).sum(-1) > -0.5).astype(
        jnp.float32)


def _torch_vis(p, d, t):
    return (torch.sin(7.0 * (p + t[:, None] * d)).sum(-1) > -0.5).float()


@pytest.mark.parametrize("diffuse_model", ["lambert", "disney"])
@pytest.mark.parametrize("occluded", [False, True])
def test_shade_emitters_matches_jax(diffuse_model, occluded):
    """Three emitters, one of which holds shading points (the whole-sphere
    branch), with and without a visibility function."""
    jargs, targs = _shade_inputs(6)
    jcfg = jrl.RenderingLayerConfig(spp=4, diffuse_model=diffuse_model)
    tcfg = trl.RenderingLayerConfig(spp=4, diffuse_model=diffuse_model)
    want = jrl.shade_emitters(
        jcfg, _key(9), *jargs, *map(jnp.asarray, EMITTERS),
        visibility_fn=_jax_vis if occluded else None)
    got = trl.shade_emitters(
        tcfg, JaxDraws(_key(9)), *targs, *map(torch.from_numpy, EMITTERS),
        visibility_fn=_torch_vis if occluded else None)
    for k in want:
        _close(got[k], want[k])
        assert float(np.abs(np.asarray(want[k])).max()) > 0.01


def _port_grads(cfg, targs, dtype=torch.float32):
    leaves = [a.to(dtype).clone().requires_grad_(True) for a in targs[3:]]
    out = trl.shade(cfg, JaxDraws(_key(11)), *(a.to(dtype) for a in targs[:3]),
                    *leaves, _torch_li)
    (out["color_diffuse"].sum() + 2.0 * out["color_specular"].sum()
     ).backward()
    return [a.grad for a in leaves]


@pytest.mark.parametrize("detach", [True, False])
def test_shade_gradient_matches_jax_grad(detach):
    """d/d(kd, ks, roughness) of the shaded sum against `jax.grad`: with
    `detach_sampling` (the material trainer's setting) only the BRDF
    values carry gradient, and all three agree at f32's tolerance.
    Without it the roughness gradient runs through the GGX sample's
    direction and its pdf, where f32 is ill-conditioned in both packages
    (each ~7e-4 from the float64 gradient of the same draws): the port's
    roughness gradient is held to the float64 one within twice the JAX
    package's own distance from it, kd and ks at f32's tolerance."""
    jargs, targs = _shade_inputs(7)
    jcfg = jrl.RenderingLayerConfig(spp=3, detach_sampling=detach)
    tcfg = trl.RenderingLayerConfig(spp=3, detach_sampling=detach)

    def jloss(kd, ks, rough):
        out = jrl.shade(jcfg, _key(11), *jargs[:3], kd, ks, rough, _jax_li)
        return (out["color_diffuse"].sum()
                + 2.0 * out["color_specular"].sum())

    want = jax.grad(jloss, argnums=(0, 1, 2))(*jargs[3:])
    got = _port_grads(tcfg, targs)
    _close(got[:2], want[:2])
    if detach:
        _close(got[2], want[2])
    else:
        f64 = _port_grads(tcfg, targs, torch.float64)[2].numpy()
        jax_gap = np.abs(np.asarray(want[2]) - f64).max()
        assert np.abs(got[2].numpy() - f64).max() <= 2 * jax_gap + 1e-5
    # the flag matters: the other setting's gradient differs
    flip = _port_grads(dataclasses.replace(tcfg, detach_sampling=not detach),
                       targs)
    assert not torch.allclose(flip[0], got[0], atol=1e-4)
