"""The NeRF++ background (`model.bg_network`) against the JAX package:
the pair of MLPs (`ops/kernels/bg_core.py`, K8/K9's plain version), the
inverted-sphere points, |sigma| density and compositing weights, the
sampler's inverse-sphere depths, and `render_rays` with a background.

Tolerances, with their reasons:
* the plain pair is f32 like the JAX package's XLA pair: outputs to 1e-5,
  gradients to 1e-4 of each leaf's largest entry (sums in other orders);
* against the Pallas kernel `bg_core_fused(interpret=True)`, which takes
  bf16 operands, the JAX package's own tolerances for it
  (`tests/test_pallas_bg.py:52-112`): sigma to 0.02 + 0.02 relative, rgb
  to 0.01 + 0.02 relative, and the cosine of the gradients over all
  leaves above 0.999 (a per-leaf bound of a bf16 computation holds only
  against a reference that rounds as it does, so the per-leaf 0.05
  against the XLA pair in bf16 holds K9's replay, in
  `test_torch_bg_replay.py`);
* the points, density and weights to 1e-5; the sampler's depths to 1e-4
  on [0, 8] (the JAX prefix sums are hi/lo-split bf16 matmuls); the
  rendered colour to 1e-4, depth and normal to 1e-3, as the eval slice's
  parity test (`test_torch_slice.py`).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.data.plot import PlotData as JaxPlotData
from i2sdf_tpu.models import density as jdensity
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu.models import sampler as jsampler
from i2sdf_tpu.models.mlp import (ImplicitNetConfig, RenderingNetConfig,
                                  implicit_net_apply, implicit_net_init,
                                  rendering_net_apply, rendering_net_init)
from i2sdf_tpu.ops import compositing as jcomp
from i2sdf_tpu.ops.pallas.fused_bg import bg_core_fused
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.models import density, renderer
from i2sdf_tpu_torch.models import sampler as tsampler
from i2sdf_tpu_torch.ops import compositing
from i2sdf_tpu_torch.ops.kernels import bg_core
from i2sdf_tpu_torch.params import from_jax_params
from test_torch_helpers import implicit_from_jax, rendering_from_jax, to_numpy
from test_torch_parity_per_ray import rays, sampler_draws
from test_torch_train_step import BG_BLOCK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(ROOT, "configs", "synthetic_quality.yml")

ICFG = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0, d_in=4,
    dims=(48, 48, 48), skip_in=(1,), geometric_init=False,
    embed_type="positional", multires=3)
ICFG_RAW = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0, d_in=4,
    dims=(32, 32), skip_in=(), geometric_init=False, embed_type=None)
RCFG = RenderingNetConfig(
    feature_vector_size=16, mode="nerf", d_in=3, dims=(32, 32),
    embed_type="positional", multires=2)

def bg_inputs(n=70):
    x = jax.random.normal(jax.random.PRNGKey(2), (n, 4)) * 0.7
    dirs = jax.random.normal(jax.random.PRNGKey(3), (n, 3))
    return x, dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)


def _xla_pair(pi, pr, icfg, rcfg, x, dirs):
    out = implicit_net_apply(pi, icfg, x)
    return out[:, :1], rendering_net_apply(pr, rcfg, None, None, dirs,
                                           out[:, 1:])


@pytest.mark.parametrize("wn", [True, False], ids=["wn", "no_wn"])
@pytest.mark.parametrize("pe", [True, False], ids=["pe", "raw"])
def test_bg_pair_matches_jax(pe, wn):
    icfg = dataclasses.replace(ICFG if pe else ICFG_RAW, weight_norm=wn)
    rcfg = dataclasses.replace(RCFG, weight_norm=wn)
    pi = implicit_net_init(jax.random.PRNGKey(0), icfg)
    pr = rendering_net_init(jax.random.PRNGKey(1), rcfg)
    x, dirs = bg_inputs()
    c_s = jax.random.normal(jax.random.PRNGKey(4), (70, 1))
    c_rgb = jax.random.normal(jax.random.PRNGKey(5), (70, 3))

    def loss(fn):
        def f(both):
            s, rgb = fn(both["i"], both["r"])
            return jnp.sum(s * c_s) + jnp.sum(rgb * c_rgb)
        return f

    both = {"i": pi, "r": pr}
    s_ref, rgb_ref = jax.jit(lambda a, b: _xla_pair(a, b, icfg, rcfg, x,
                                                    dirs))(pi, pr)
    s_ker, rgb_ker = jax.jit(lambda a, b: bg_core_fused(
        a, icfg, b, rcfg, x, dirs, block_rows=32, interpret=True))(pi, pr)
    g_ref = jax.jit(jax.grad(loss(lambda a, b: _xla_pair(
        a, b, icfg, rcfg, x, dirs))))(both)
    g_ker = jax.jit(jax.grad(loss(lambda a, b: bg_core_fused(
        a, icfg, b, rcfg, x, dirs, block_rows=32, interpret=True))))(both)

    net_i, net_r = implicit_from_jax(pi, icfg), rendering_from_jax(pr, rcfg)
    w = bg_core.BgWeights.of(net_i, net_r)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    s, rgb = bg_core.bg_core(net_i.cfg, net_r.cfg, w, t(x), t(dirs))
    ((s * t(c_s)).sum() + (rgb * t(c_rgb)).sum()).backward()
    # forward: f32 XLA tightly, the bf16 kernel at its own tolerances
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ker),
                               atol=0.02, rtol=0.02)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_ker),
                               atol=0.01, rtol=0.02)
    # gradients, leaf by leaf
    got = {("i", k): p.grad.numpy() for k, p in net_i.named_parameters()}
    got |= {("r", k): p.grad.numpy() for k, p in net_r.named_parameters()}
    mine, ker = [], []
    for net in ("i", "r"):
        for lin, leaves in to_numpy(g_ref[net]).items():
            for leaf, ref in leaves.items():
                g = got[(net, f"{lin}.{leaf}")]
                scale = max(np.abs(ref).max(), 1e-3)
                assert np.abs(g - ref).max() / scale < 1e-4, (net, lin, leaf)
                mine.append(g.ravel())
                ker.append(np.asarray(g_ker[net][lin][leaf]).ravel())
    a, b = np.concatenate(mine), np.concatenate(ker)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


def test_bg_points_density_and_weights_match_jax():
    rng = np.random.default_rng(0)
    R, S, sphere = 40, 32, 4.0
    cam = rng.uniform(-2.0, 2.0, (R, 1, 3)).astype(np.float32)
    d = rng.normal(size=(R, 1, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cam, d = np.broadcast_to(cam, (R, S, 3)), np.broadcast_to(d, (R, S, 3))
    z = np.sort(rng.uniform(0, 1 / sphere, (R, S)), -1)[:, ::-1].astype(
        np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pts = renderer.depth2pts_outside(t(cam), t(d), t(z), sphere)
    ref = jrenderer.depth2pts_outside(cam, d, z, sphere)
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref), atol=1e-5)
    sigma = rng.normal(size=(R, S)).astype(np.float32) * 3
    dens = density.abs_density(t(sigma))
    np.testing.assert_array_equal(dens.numpy(),
                                  np.asarray(jdensity.abs_density(sigma)))
    w = compositing.render_weights_bg(t(z), dens)
    wr = jcomp.render_weights_bg(z, jdensity.abs_density(sigma))
    np.testing.assert_allclose(w.numpy(), np.asarray(wr), atol=1e-5)
    # the last interval is 1e10 wide: a ray opaque only at its last sample
    # keeps the rest of its transmittance there
    dens2 = torch.zeros((1, S))
    dens2[0, -1] = 1.0
    w2 = compositing.render_weights_bg(t(z[:1]), dens2)
    assert float(w2[0, :-1].abs().max()) == 0.0 and float(w2[0, -1]) == 1.0


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_inverse_sphere_samples_match_jax(training):
    """With the background the sampler's far depth is the scene sphere's
    far intersection, and it returns the background's inverse depths,
    jittered in training (the JAX sampler's key -1)."""
    kw = dict(scene_bounding_sphere=4.0, N_samples=16, N_samples_eval=32,
              N_samples_extra=8, eps=0.1, beta_iters=6, max_total_iters=3,
              add_tiny=1e-6, inverse_sphere_bg=True,
              N_samples_inverse_sphere=12)
    jcfg, tcfg = jsampler.SamplerConfig(**kw), tsampler.SamplerConfig(**kw)
    R = 24
    (cam, dirs), (cam2, dirs2) = rays(R // 2, True), rays(R // 2, False)
    cam, dirs = np.concatenate([cam, cam2]), np.concatenate([dirs, dirs2])
    key = jax.random.PRNGKey(9)
    z_ref, zbg_ref, _ = jax.jit(lambda dd, cc: jsampler.error_bound_z_vals(
        jcfg, lambda p: jnp.linalg.norm(p, axis=-1) - 1.0, key, dd, cc,
        np.float32(0.01), training=training))(dirs, cam)
    z, z_bg = tsampler.error_bound_z_vals(
        tcfg, lambda p: torch.linalg.norm(p, dim=-1) - 1.0,
        torch.from_numpy(dirs), torch.from_numpy(cam), torch.tensor(0.01),
        draws=sampler_draws(jcfg, key, R) if training else None)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4)
    np.testing.assert_allclose(z_bg.numpy(), np.asarray(zbg_ref), atol=1e-7)
    far = z.numpy()[:, -1]   # the sphere's far side, short of 2 x 4
    assert (far < 8.0).all() and (far > 4.0).all()
    assert z_bg.shape == (R, 12) and float(z_bg.max()) <= 0.25


def test_render_rays_with_background_matches_jax(tmp_path):
    text = open(QUALITY).read()
    text = (text.replace("dims: [256, 256, 256, 256, 256, 256, 256, 256]",
                         "dims: [64, 64, 64, 64]")
            .replace("skip_in: [4]", "skip_in: [2]")
            .replace("dims: [256, 256, 256, 256]", "dims: [64, 64]")
            .replace("feature_vector_size: 256", "feature_vector_size: 32")
            .replace("    density:\n", BG_BLOCK + "    density:\n"))
    path = str(tmp_path / "bg.yml")
    with open(path, "w") as f:
        f.write(text)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jax_load_cfg(path).model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(path).model)
    assert tcfg.use_bg and tcfg.sampler.inverse_sphere_bg
    assert tcfg.bg_implicit.layer_dims() == jcfg.bg_implicit.layer_dims()
    params = jrenderer.init(jax.random.PRNGKey(0), jcfg)
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(to_numpy(params), tcfg))
    pd = JaxPlotData(data_dir="synthetic_quality", scan_id=1,
                     data_root=os.path.join(ROOT, "data"), downsample=2,
                     indices=[0])
    uv, K, pose = pd.uv, pd.intrinsics_all[0], pd.pose_all[0]
    sel = np.random.default_rng(0).choice(len(uv), 48, replace=False)
    inputs = {"uv": uv[sel][None], "intrinsics": K[None], "pose": pose[None]}
    ref = jax.jit(lambda p, i: jrenderer.render_rays(
        p, jcfg, i, jax.random.PRNGKey(0), training=False,
        fused_sampler=False))(params, {k: jnp.asarray(v)
                                       for k, v in inputs.items()})
    got = renderer.render_rays(model, {k: torch.from_numpy(np.array(v))
                                       for k, v in inputs.items()})
    for key, tol in (("rgb_values", 1e-4), ("depth_values", 1e-3),
                     ("normal_map", 1e-3), ("weight_sum", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=tol, err_msg=key)
    # the background shows: the colour differs from the foreground's own
    fg = model.cfg
    no_bg = dataclasses.replace(fg, bg_implicit=None, bg_rendering=None)
    plain = renderer.I2SDFModel(no_bg)
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("bg_")})
    fg_only = renderer.render_rays(plain, {k: torch.from_numpy(np.array(v))
                                           for k, v in inputs.items()})
    diff = (got["rgb_values"] - fg_only["rgb_values"]).abs()
    assert float(diff.max()) > 1e-3


@pytest.mark.parametrize("pe", [True, False], ids=["pe", "raw"])
def test_bg_kernel_replay_matches_jax_bf16(pe):
    """K8/K9's replay, rounding where the kernels round
    (`test_torch_bg_replay.py`), against the JAX package's XLA pair
    computed in bf16, per leaf within 0.05 of the leaf's largest entry, and
    against it in f32 by a cosine above 0.999 (the tolerances of
    `tests/test_pallas_bg.py:76-112` for the JAX package's own kernel)."""
    from test_torch_bg_replay import ICFG as T_ICFG
    from test_torch_bg_replay import ICFG_RAW as T_ICFG_RAW
    from test_torch_bg_replay import RCFG as T_RCFG
    from test_torch_bg_replay import replay_bwd, replay_fwd
    jfields = lambda c, cls: cls(**{  # noqa: E731
        f.name: getattr(c, f.name) for f in dataclasses.fields(c)})
    icfg = jfields(T_ICFG if pe else T_ICFG_RAW, ImplicitNetConfig)
    rcfg = jfields(T_RCFG, RenderingNetConfig)
    pi = implicit_net_init(jax.random.PRNGKey(0), icfg)
    pr = rendering_net_init(jax.random.PRNGKey(1), rcfg)
    x, d = (np.array(a, np.float32) for a in bg_inputs())
    c = np.array(jax.random.normal(jax.random.PRNGKey(4), (70, 4)),
                 np.float32)
    net_i, net_r = implicit_from_jax(pi, icfg), rendering_from_jax(pr, rcfg)
    with torch.no_grad():
        k = bg_core.BgLayout(net_i.cfg, net_r.cfg,
                             bg_core.BgWeights.of(net_i, net_r))
    x4, dirs, cot = (torch.from_numpy(a) for a in (x, d, c))
    s, rgb, _, _ = replay_fwd(k, x4, dirs)

    def pair(icfg_, rcfg_):
        def f(both):
            s_, rgb_ = _xla_pair(both["i"], both["r"], icfg_, rcfg_, x, d)
            return jnp.sum(s_ * c[:, :1]) + jnp.sum(rgb_ * c[:, 1:])
        return f

    both = {"i": pi, "r": pr}
    g32 = jax.jit(jax.grad(pair(icfg, rcfg)))(both)
    g16 = jax.jit(jax.grad(pair(
        dataclasses.replace(icfg, compute_dtype="bfloat16"),
        dataclasses.replace(rcfg, compute_dtype="bfloat16"))))(both)
    s_ref, rgb_ref = jax.jit(lambda a, b: _xla_pair(a, b, icfg, rcfg, x,
                                                    d))(pi, pr)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=0.02,
                               rtol=0.02)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), atol=0.01,
                               rtol=0.02)
    dwi, dbi, dwr, dbr = replay_bwd(k, x4, dirs, cot)
    got = {("i", f"lin{l}", "w"): g for l, g in enumerate(dwi)}
    got |= {("i", f"lin{l}", "b"): g for l, g in enumerate(dbi)}
    got |= {("r", f"lin{l}", "w"): g for l, g in enumerate(dwr)}
    got |= {("r", f"lin{l}", "b"): g for l, g in enumerate(dbr)}
    a, b = [], []
    for (net, lin, leaf), g in got.items():
        r16 = np.asarray(g16[net][lin][leaf])
        scale = max(np.abs(r16).max(), 1e-3)
        assert np.abs(g.numpy() - r16).max() / scale < 0.05, (net, lin, leaf)
        a.append(g.numpy().ravel())
        b.append(np.asarray(g32[net][lin][leaf]).ravel())
    a, b = np.concatenate(a), np.concatenate(b)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
