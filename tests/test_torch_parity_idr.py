"""The idr-mode radiance net through the render core
(`i2sdf_tpu_torch/ops/kernels/render_core.py`: K3 and K4's `idr`
instantiations) against the JAX package on the same parameters, points
and cotangents. The radiance input is [points | PE(view) | normals |
features] in the nets' order (VolSDF's DTU / IDR radiance net, `d_in` 9),
[features | PE(view) | pts | grad] in the kernels'.

* The plain op (`render_core_plain`, `render_core_train_plain`) against
  the XLA composition `mlp.sdf_outputs` + `mlp.rendering_net_apply` (both
  f32: 1e-5, gradients to 1e-4 of each leaf's largest entry) and the
  Pallas op `render_core_fused` (idr) in interpret mode at the JAX
  package's tolerances for that branch (`tests/test_pallas_train.py:
  234-248`: sdf 0.02, grad 0.05 / rtol 0.08, rgb 0.03 / rtol 0.05), at the
  init's weights and at weights perturbed by 0.01 N(0, 1) (a swapped pts
  / grad pair passes at a sphere's init, where grad ~ x / |x|).
* With a bounding sphere the radiance net of the Pallas op sees the
  gradient before the clamp (`_rad_input`; the clamp is the wrapper's,
  `fused_train.py:771-777`) and the XLA composition the clamped one
  (`mlp.py:216-224,253-276`): past the clamp the plain op is held to
  `render_core_fused`, which it follows, not to the XLA composition. The
  renderer's nets never have a sphere (`renderer.py:67`).
* The parameter gradients at a loss's cotangents against the Pallas op's
  backward in interpret mode: cosine > 0.999 over all leaves and per leaf
  no further from it than the f32 XLA gradient is (+1e-3), as
  `test_torch_train_render_core.py` holds the nerf op.
* K3-idr's and K4-idr's replays (the kernels' layouts and rounding,
  `test_torch_kernel_layout.py`, `test_torch_bwd_replay.py`) against the
  Pallas op in interpret mode: the forward at the tolerances above, the
  backward at the JAX package's kernel-gradient check (per leaf < 0.1,
  cosine > 0.999).
* `supports_render_core` against the JAX predicate, and `params.py` on
  the idr radiance layer 0.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu.models.mlp import (ImplicitNetConfig, RenderingNetConfig,
                                  implicit_net_init, rendering_net_apply,
                                  rendering_net_init, sdf_outputs)
from i2sdf_tpu.ops.pallas.fused_train import (render_core_fused,
                                              supports_render_core)
from i2sdf_tpu_torch.models import mlp as tmlp
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.ops.kernels import render_core
from i2sdf_tpu_torch.params import from_jax_params, to_jax_params
from test_torch_helpers import (implicit_from_jax, perturbed,
                                rendering_from_jax, to_numpy)
from test_torch_kernel_layout import emulate_render_core

ICFG = ImplicitNetConfig(
    feature_vector_size=16, sdf_bounding_sphere=0.0,
    dims=(64, 64, 64, 64), skip_in=(2,), bias=0.6,
    embed_type="positional", multires=4)
RCFG = RenderingNetConfig(
    feature_vector_size=16, mode="idr", d_in=9, dims=(32, 32),
    embed_type="positional", multires=3)
TOLS = {"sdf": (0.02, 0.02), "grad": (0.05, 0.08), "rgb": (0.03, 0.05)}
WEIGHTS = pytest.mark.parametrize("weights", ["init", "perturbed"])


def _setup(n, seed=0, perturb=False, icfg=ICFG, scale=0.8):
    p_imp = implicit_net_init(jax.random.PRNGKey(seed), icfg)
    p_rad = rendering_net_init(jax.random.PRNGKey(seed + 1), RCFG)
    if perturb:
        p_imp, p_rad = perturbed(p_imp, seed + 10), perturbed(p_rad, seed + 11)
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    net, rnet = implicit_from_jax(p_imp, icfg), rendering_from_jax(p_rad,
                                                                    RCFG)
    assert rnet.cfg.mode == "idr" and rnet.cfg.layer_dims()[0] == 16 + 21 + 6
    return p_imp, p_rad, pts, dirs, net, rnet


def _close(got, want, tols=TOLS):
    for name, g, w in zip(tols, got, want):
        atol, rtol = tols[name]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=rtol, err_msg=name)


@WEIGHTS
def test_plain_matches_xla(weights):
    p_imp, p_rad, pts, dirs, net, rnet = _setup(96,
                                                perturb=weights != "init")

    @jax.jit
    def ref(pi, pr, x, d):
        s, f, g = sdf_outputs(pi, ICFG, x)
        return s, g, rendering_net_apply(pr, RCFG, x, g, d, f)

    got = render_core.render_core_plain(net, rnet, torch.from_numpy(pts),
                                        torch.from_numpy(dirs))
    _close([t.numpy() for t in got], ref(p_imp, p_rad, pts, dirs),
           {k: (1e-5, 1e-5) for k in TOLS})


@WEIGHTS
def test_plain_matches_pallas_interpret(weights):
    p_imp, p_rad, pts, dirs, net, rnet = _setup(96, 1,
                                                perturb=weights != "init")
    ker = render_core_fused(p_imp, ICFG, p_rad, RCFG, pts, dirs,
                            block_rows=32, interpret=True)
    got = render_core.render_core_plain(net, rnet, torch.from_numpy(pts),
                                        torch.from_numpy(dirs))
    _close([t.numpy() for t in got], ker)


def test_past_the_clamp_plain_follows_the_pallas_op():
    """A sphere of radius 1 with a third of the points outside it: the
    clamped sdf and gradient, and the radiance on the unclamped gradient,
    as `render_core_fused` computes them; the XLA composition's rgb
    differs where the clamp takes the sphere (its radiance sees the
    clamped gradient)."""
    icfg = dataclasses.replace(ICFG, sdf_bounding_sphere=1.0)
    p_imp, p_rad, pts, dirs, net, rnet = _setup(96, 2, perturb=True,
                                                icfg=icfg, scale=1.0)
    ker = render_core_fused(p_imp, icfg, p_rad, RCFG, pts, dirs,
                            block_rows=32, interpret=True)
    got = render_core.render_core_plain(net, rnet, torch.from_numpy(pts),
                                        torch.from_numpy(dirs))
    _close([t.numpy() for t in got], ker)
    s, f, g = sdf_outputs(p_imp, icfg, pts)
    xla_rgb = np.asarray(rendering_net_apply(p_rad, RCFG, pts, g, dirs, f))
    w = render_core.CoreWeights.of(net, rnet)
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    raw = render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d)
    took = (1.0 - np.linalg.norm(pts, axis=-1)
            < raw[0][:, 0].detach().numpy())
    assert 10 < took.sum() < 86
    assert np.abs(xla_rgb[took] - got[2].numpy()[took]).max() > 1e-4
    np.testing.assert_allclose(got[2].numpy()[~took], xla_rgb[~took],
                               atol=1e-5)
    # the training op: the same function, the clamp composed outside
    tr = render_core.render_core_train(net.cfg, rnet.cfg, w, x, d)
    for a, b in zip(tr, got):
        torch.testing.assert_close(a.detach(), b, atol=1e-6, rtol=1e-6)


def _grads_by_name(gi, gr):
    return {f"{net}.{lin}.{leaf}": np.asarray(v)
            for net, tree in (("implicit", gi), ("rendering", gr))
            for lin, leaves in tree.items() for leaf, v in leaves.items()}


def _port_vjp(net, rnet, pts, dirs, cot):
    w = render_core.CoreWeights.of(net, rnet)
    outs = render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, torch.from_numpy(pts), torch.from_numpy(dirs))
    c = torch.from_numpy(cot)
    names = ([f"implicit.{k}" for k, _ in net.named_parameters()]
             + [f"rendering.{k}" for k, _ in rnet.named_parameters()])
    leaves = list(net.parameters()) + list(rnet.parameters())
    gs = torch.autograd.grad(outs, leaves, (c[:, 3:4], c[:, :3], c[:, 4:7]))
    return {k: g.numpy() for k, g in zip(names, gs)}


def _jax_vjp(f, p_imp, p_rad, cot):
    _, vjp = jax.vjp(f, p_imp, p_rad)
    return _grads_by_name(*vjp((cot[:, :3], cot[:, 3:4], cot[:, 4:7])))


def _cos(got, ref):
    a = np.concatenate([ref[k].ravel() for k in ref]).astype(np.float64)
    b = np.concatenate([got[k].ravel() for k in ref]).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _leaf_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)


def _loss_cot(net, rnet, pts, dirs, eik):
    from test_torch_bwd_replay import eik_only, loss_cotangents
    w = render_core.CoreWeights.of(net, rnet)
    cot = loss_cotangents(*render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, torch.from_numpy(pts),
        torch.from_numpy(dirs)))
    return eik_only(cot, eik)


@WEIGHTS
def test_plain_backward_matches_xla_and_pallas_interpret(weights):
    p_imp, p_rad, pts, dirs, net, rnet = _setup(256, 3,
                                                perturb=weights != "init")
    eik = 64
    dirs[-eik:] = 0.0
    cot = _loss_cot(net, rnet, pts, dirs, eik).numpy()

    def xla(pi, pr):
        s, f, g = sdf_outputs(pi, ICFG, pts)
        return g, s, rendering_net_apply(pr, RCFG, pts, g, dirs, f)

    def pallas(pi, pr):
        s, g, rgb = render_core_fused(pi, ICFG, pr, RCFG, pts, dirs,
                                      block_rows=64, interpret=True)
        return g, s, rgb

    ref = _jax_vjp(xla, p_imp, p_rad, cot)
    ker = _jax_vjp(pallas, p_imp, p_rad, cot)
    got = _port_vjp(net, rnet, pts, dirs, cot)
    assert set(got) == set(ref)
    for k in ref:
        scale = max(np.abs(ref[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4 * scale, rtol=0,
                                   err_msg=k)
    assert _cos(got, ker) > 0.999
    for k in ker:
        assert _leaf_err(got[k], ker[k]) <= _leaf_err(ref[k], ker[k]) + 1e-3, k
    # the radiance input's gradient columns carry a cotangent into the SDF
    # net: the SDF leaves move when the rgb cotangent alone is given
    only_rgb = cot.copy()
    only_rgb[:, :4] = 0.0
    g_rgb = _port_vjp(net, rnet, pts, dirs, only_rgb)
    assert np.abs(g_rgb["implicit.lin0.v"]).max() > 0


@WEIGHTS
def test_k3_idr_replay_matches_pallas_interpret(weights):
    """K3-idr's four-stream replay on its stage images against the Pallas
    kernel's idr forward in interpret mode, at its tolerances."""
    p_imp, p_rad, pts, dirs, net, rnet = _setup(64, 4,
                                                perturb=weights != "init")
    ker = render_core_fused(p_imp, ICFG, p_rad, RCFG, pts, dirs,
                            block_rows=32, interpret=True)
    k = render_core.CoreStages(net.cfg, rnet.cfg,
                               render_core.CoreWeights.of(net, rnet))
    got = emulate_render_core(k, torch.from_numpy(pts),
                              torch.from_numpy(dirs))
    _close([t.numpy() for t in got], ker)


@WEIGHTS
def test_k4_idr_replay_matches_pallas_interpret(weights):
    """K4-idr's replay (handed K3-idr's replayed gradient, as the op hands
    K3's) against the Pallas op's idr backward in interpret mode, two bf16
    kernels rounding in different places, at the loss's cotangents: per
    leaf < 0.1, cosine > 0.999."""
    from test_torch_bwd_replay import emulate_bwd
    p_imp, p_rad, pts, dirs, net, rnet = _setup(256, 5,
                                                perturb=weights != "init")
    eik = 64
    dirs[-eik:] = 0.0
    cot = _loss_cot(net, rnet, pts, dirs, eik)
    c = cot.numpy()

    def pallas(pi, pr):
        s, g, rgb = render_core_fused(pi, ICFG, pr, RCFG, pts, dirs,
                                      block_rows=64, interpret=True)
        return g, s, rgb

    ker = _jax_vjp(pallas, p_imp, p_rad, c)
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    w = render_core.CoreWeights.of(net, rnet)
    st = render_core.CoreStages(net.cfg, rnet.cfg, w)
    g3 = emulate_render_core(st, x, d)[1]
    rep = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, cot,
                                    grad=g3) for t in grp]
    names = ([f"implicit.{k}" for k, _ in net.named_parameters()]
             + [f"rendering.{k}" for k, _ in rnet.named_parameters()])
    leaves = list(net.parameters()) + list(rnet.parameters())
    gs = torch.autograd.grad(w.flat(), leaves, rep)
    got = {k: g.numpy() for k, g in zip(names, gs)}
    assert _cos(got, ker) > 0.999
    for k in ker:
        assert _leaf_err(got[k], ker[k]) < 0.1, k


def _jax_cfgs():
    icfg = ImplicitNetConfig(feature_vector_size=16, sdf_bounding_sphere=0.0,
                             dims=(32, 32), embed_type="positional",
                             multires=4)
    base = dict(feature_vector_size=16, dims=(32,), embed_type="positional",
                multires=4)
    rcfgs = {"nerf": RenderingNetConfig(**base),
             "idr": RenderingNetConfig(**base, mode="idr", d_in=9),
             "idr_points": RenderingNetConfig(**base, mode="idr", d_in=9,
                                              embed_point_multires=4),
             "sh": RenderingNetConfig(**{**base, "embed_type":
                                         "spherical_harmonics"}),
             "idr_sh": RenderingNetConfig(**{**base, "embed_type":
                                             "spherical_harmonics"},
                                          mode="idr", d_in=9)}
    light = ImplicitNetConfig(feature_vector_size=0, sdf_bounding_sphere=0.0,
                              d_in=16, d_out=1, dims=(8,),
                              geometric_init=False,
                              output_activation="sigmoid")
    return icfg, rcfgs, light


@pytest.mark.parametrize("name", ["nerf", "idr", "idr_points", "sh",
                                  "idr_sh"])
@pytest.mark.parametrize("light", [False, True])
def test_supports_render_core_matches_jax(name, light):
    icfg, rcfgs, lcfg = _jax_cfgs()
    rcfg = rcfgs[name]
    want = supports_render_core(icfg, rcfg, lcfg if light else None)
    t = {"icfg": renderer.ImplicitNetConfig, "rcfg": tmlp.RenderingNetConfig}
    conv = lambda cls, c: cls(**{f.name: getattr(c, f.name)  # noqa: E731
                                 for f in dataclasses.fields(cls)})
    got = renderer.supports_render_core(
        conv(t["icfg"], icfg), conv(t["rcfg"], rcfg),
        conv(t["icfg"], lcfg) if light else None)
    assert got == want
    assert want == (name in ("nerf", "idr"))


def test_params_carry_the_idr_radiance_layer_in_the_nets_row_order(tmp_path):
    """The converter on an idr model: radiance layer 0 crosses as (289,
    256) in the nets' row order [pts, PE(view), normals, features], so the
    port's net gives the JAX net's rgb on the same inputs, and the tree
    comes back unchanged; the kernels' pack then holds its rows in their
    order (`_rad_perm`), which `unpack_grads` inverts."""
    from i2sdf_tpu.config import load_cfg as jax_load_cfg
    from i2sdf_tpu_torch.config import load_cfg
    path = tmp_path / "idr.yml"
    text = open("configs/synthetic_quality.yml").read().replace(
        "mode: nerf\n        d_in: 3", "mode: idr\n        d_in: 9")
    assert "mode: idr" in text
    path.write_text(text)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jax_load_cfg(str(path)).model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(str(path)).model)
    assert tcfg.rendering.mode == "idr" and tcfg.rendering.d_in == 9
    params = to_numpy(jrenderer.init(jax.random.PRNGKey(0), jcfg))
    sd = from_jax_params(params, tcfg)
    assert tuple(sd["rendering.lin0.v"].shape) == (289, 256)
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(sd)
    back = to_jax_params(model.state_dict())
    for lin, leaves in params["rendering"].items():
        for leaf, v in leaves.items():
            assert np.array_equal(back["rendering"][lin][leaf], v)
    rng = np.random.default_rng(0)
    pts, nrm, feat = (rng.normal(size=(7, k)).astype(np.float32)
                      for k in (3, 3, 256))
    d = rng.normal(size=(7, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = rendering_net_apply(params["rendering"], jcfg.rendering, pts, nrm,
                               d, feat)
    got = model.rendering(*(torch.from_numpy(a) for a in (d, feat, pts, nrm)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    w = render_core.CoreWeights.of(model.implicit, model.rendering)
    st = render_core.CoreStages(tcfg.implicit, tcfg.rendering, w)
    perm = render_core._rad_perm(27, 256, True)
    w0 = w.ws_rad[0].detach()
    assert torch.equal(w0[perm][np.argsort(perm)], w0)
    assert st.rad_in == 289 and st.vdim == 27


def test_light_head_with_idr_is_refused():
    """The light head beside the idr-mode radiance net was refused until
    the render core ran them together: now the model builds, the port's
    `supports_render_core` agrees with the JAX predicate, the render core
    packs the three nets, and only an idr net with a point encoding is
    refused by the kernels (which the JAX predicate refuses too)."""
    icfg, rcfgs, lcfg = _jax_cfgs()
    conv = lambda cls, c: cls(**{f.name: getattr(c, f.name)  # noqa: E731
                                 for f in dataclasses.fields(cls)})
    cfg = renderer.I2SDFConfig(
        feature_vector_size=16,
        implicit=conv(renderer.ImplicitNetConfig, icfg),
        rendering=conv(tmlp.RenderingNetConfig, rcfgs["idr"]),
        light=conv(renderer.ImplicitNetConfig, lcfg))
    model = renderer.I2SDFModel(cfg)
    assert renderer.uses_render_core(cfg)
    assert supports_render_core(icfg, rcfgs["idr"], lcfg)
    render_core.check_radiance_net(cfg.rendering)
    st = render_core.CoreStages(
        cfg.implicit, cfg.rendering,
        render_core.CoreWeights.of(model.implicit, model.rendering,
                                   model.light), cfg.light)
    assert st.idr and st.n_light == 2
    with pytest.raises(ValueError, match="point encoding"):
        render_core.check_radiance_net(dataclasses.replace(
            cfg.rendering, embed_point_multires=2))
