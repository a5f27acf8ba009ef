"""The port's material stage, function by function, against the JAX
package's on the CPU (`i2sdf_tpu_torch/models/material.py`,
`data/material.py`, `train/material.py`, `params.material_*`): the same
numpy-seeded inputs and the JAX parameters carried across with the
converter, the draws JAX's own (`JaxDraws`). Tolerances:

- the material net and the emission functions: atol 1e-5 (f32 on both
  sides, the same weights);
- `MaterialData`: intrinsics, poses and uv exact, images at rtol 1e-6
  (OpenCV's INTER_AREA against `imaging.resize_area`, float32);
- the bake (the eval render of a narrow perturbed model): the valid
  flags equal; points, normals and view directions at atol 1e-5 at all
  but 1 % of the valid pixels, and all within 0.05 (one pixel of view 2
  here, where the two samplers' float decisions part); the Newton
  projection at atol 1e-5;
- `loss_fn` (through the JAX step with a transformation that hands back
  the gradients): metrics at rtol 1e-4, each gradient leaf within 1e-4
  of the leaf's largest magnitude; `calibrate`'s emission at atol 1e-5;
- Adam (eps 1e-15): the first update equal to 1e-4 of the learning rate
  (the two libraries round its division apart) where the gradient is
  above 1e-3 of its leaf's largest (elsewhere a near-zero gradient's
  sign decides a full-lr step), the parameters after three steps within
  three learning rates;
- the converter's round trip exact.

The scene is the JAX package's `generate_synthetic_scene` (3 images of
20 x 24), made once for the module."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from i2sdf_tpu.data import generate_synthetic_scene
from i2sdf_tpu.data.material import MaterialData as JMaterialData
from i2sdf_tpu.models import material as jmat
from i2sdf_tpu.train import material as jtm
from i2sdf_tpu.train.state import TrainState, make_optimizer
from i2sdf_tpu.train.step import make_eval_render_fn as jax_eval_render
from i2sdf_tpu_torch.data.material import MaterialData
from i2sdf_tpu_torch.models import material as tmat
from i2sdf_tpu_torch.params import material_from_jax, material_to_jax
from i2sdf_tpu_torch.train import material as ttm
from i2sdf_tpu_torch.train.state import create_train_state
from i2sdf_tpu_torch.train.step import make_eval_render_fn
from test_torch_helpers import JaxDraws, to_numpy
from test_torch_relight_cli import light_pair

CENTERS = np.array([[0.0, 2.5, 0.0]], np.float32)
RADII = np.array([0.3], np.float32)
OCC_C, OCC_R = np.array([0.0, 1.6, 0.3], np.float32), 0.25


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("material_scene")
    generate_synthetic_scene(str(root / "demo"), n_images=3,
                             img_res=(20, 24))
    return str(root)


def _configs():
    jcfg = jmat.MaterialNetConfig(dims=(16, 16), multires=2)
    tcfg = tmat.MaterialNetConfig(dims=(16, 16), multires=2)
    return jcfg, tcfg


def _stage_pair(radiance, seed=0):
    """JAX material-stage parameters (the init, perturbed) and the port's
    `MaterialStage` with the same values."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(seed)
    tree = to_numpy({"material": jmat.material_net_init(
        jax.random.PRNGKey(seed), jcfg),
        "emission": jmat.emission_init(radiance)})
    tree = jax.tree_util.tree_map(
        lambda v: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32),
        tree)
    stage = tmat.MaterialStage(tcfg, radiance)
    stage.load_state_dict(material_from_jax(tree, stage))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), stage


def test_material_net_and_emission_match_jax():
    radiance = np.array([[3.0, 2.0, 1.0], [0.5, 0.0, 2.0]], np.float32)
    jcfg, params, stage = _stage_pair(radiance)
    x = np.random.default_rng(1).uniform(-1.5, 1.5, (300, 3)).astype(
        np.float32)
    want = jmat.material_net_apply(params["material"], jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = stage.material(torch.from_numpy(x))
    for k in ("kd", "ks", "rough"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    assert float(got["rough"].min()) >= 0.04
    init_j = jmat.emission_init(radiance, ambient=0.03)
    init_t = tmat.emission_init(radiance, ambient=0.03)
    for k in ("log_radiance", "log_ambient"):
        np.testing.assert_allclose(init_t[k].numpy(), np.asarray(init_j[k]),
                                   atol=1e-6)
    np.testing.assert_allclose(
        tmat.emission_apply(stage.emission).detach().numpy(),
        np.asarray(jmat.emission_apply(params["emission"])), atol=1e-5)
    np.testing.assert_allclose(
        tmat.ambient_apply(stage.emission).detach().numpy(),
        np.asarray(jmat.ambient_apply(params["emission"])), atol=1e-5)
    # parameters from before the ambient existed: zeros
    only = {"log_radiance": init_t["log_radiance"]}
    assert tmat.ambient_apply(only).tolist() == [0.0, 0.0, 0.0]
    assert np.asarray(jmat.ambient_apply(
        {"log_radiance": init_j["log_radiance"]})).tolist() == [0.0] * 3


def test_material_config_from_cfgnode():
    from i2sdf_tpu.config import CfgNode as JNode
    from i2sdf_tpu_torch.config import CfgNode as TNode

    node = {"dims": [32, 8], "multires": 3, "min_roughness": 0.1}
    j = jmat.MaterialNetConfig.from_cfgnode(JNode(node))
    t = tmat.MaterialNetConfig.from_cfgnode(TNode(node))
    assert t.layer_dims() == j.layer_dims() == [21, 32, 8, 7]
    assert t.min_roughness == j.min_roughness == 0.1
    tc = ttm.MaterialTrainConfig.from_cfgnode(TNode({"spp": 4}))
    jc = jtm.MaterialTrainConfig.from_cfgnode(JNode({"spp": 4}))
    import dataclasses
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    with pytest.raises(ValueError, match="not ported"):
        tmat.MaterialNetConfig(embed_type="fourier")


def test_converter_round_trip():
    radiance = np.array([[1.0, 2.0, 3.0]], np.float32)
    _, params, stage = _stage_pair(radiance, seed=3)
    back = material_to_jax(stage.state_dict())
    want = to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    bad = to_numpy(params)
    bad["material"]["lin0"]["v"] = bad["material"]["lin0"]["v"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        material_from_jax(bad, stage)


@pytest.mark.parametrize("factor,hdr", [(1, False), (2, False), (1, True),
                                        (2, True)])
def test_material_data_matches_jax(scene, factor, hdr):
    kw = dict(scan_id=0, data_root=scene, use_mask=True, is_hdr=hdr,
              downsample_train=factor)
    got, want = MaterialData("demo", **kw), JMaterialData("demo", **kw)
    assert got.img_res == want.img_res == [20 // factor, 24 // factor]
    assert got.n_images == want.n_images == 3
    for a in ("intrinsics_all", "pose_all", "uv", "mask_images"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    np.testing.assert_allclose(got.rgb_images, want.rgb_images, rtol=1e-6,
                               atol=1e-7)
    assert len(got) == len(want)


def test_bake_and_projection_match_jax(scene, tmp_path):
    jcfg, params, model, _ = light_pair(str(tmp_path))
    data = MaterialData("demo", data_root=scene)
    j_render, _ = jax_eval_render(jcfg, chunk_size=512, fused_sampler=False)
    t_render = make_eval_render_fn(model, chunk_size=512, fused=False)
    for i in range(3):
        uv, K, pose = data.uv, data.intrinsics_all[i], data.pose_all[i]
        want = jtm.bake_image_geometry(params, j_render, uv, K, pose,
                                       min_weight_sum=0.3)
        got = ttm.bake_image_geometry(
            t_render, *(torch.from_numpy(a) for a in (uv, K, pose)),
            min_weight_sum=0.3)
        valid = np.asarray(want["valid"])
        np.testing.assert_array_equal(got["valid"].numpy(), valid)
        assert 0 < valid.sum()
        for k in ("points", "normals", "view_dirs"):
            gap = np.abs(got[k].numpy()[valid]
                         - np.asarray(want[k])[valid]).max(-1)
            assert (gap > 1e-5).sum() <= 0.01 * valid.sum(), (k, i)
            assert gap.max() < 0.05, (k, i)
    pts = np.random.default_rng(2).normal(size=(300, 3)).astype(
        np.float32) * 0.8
    want = jtm.project_to_surface(params["implicit"], jcfg.implicit,
                                  jnp.asarray(pts), chunk=128)
    got = ttm.project_to_surface(model.implicit, torch.from_numpy(pts),
                                 chunk=128)
    assert got.shape == (300, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def _buffers(n=400, seed=0, e_ind=False):
    """Samples on the unit sphere's upper half (outward normals, view
    directions toward their hemisphere), seeded observed colours and
    optionally a bounce buffer."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm[:, 1] = np.abs(nrm[:, 1])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    vd = nrm + 0.8 * rng.normal(size=(n, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    out = {"points": nrm, "normals": nrm, "view_dirs": vd,
           "rgb": rng.uniform(0.02, 1.5, (n, 3))}
    if e_ind:
        out["e_ind"] = rng.uniform(0.0, 0.3, (n, 3))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _jsdf(p):
    return jnp.minimum(jnp.linalg.norm(p, axis=-1) - 1.0,
                       jnp.linalg.norm(p - OCC_C, axis=-1) - OCC_R)


def _tsdf(p):
    return torch.minimum(torch.linalg.norm(p, dim=-1) - 1.0,
                         torch.linalg.norm(p - torch.from_numpy(OCC_C),
                                           dim=-1) - OCC_R)


TCFG = dict(batch_size=64, spp=4, vis_steps=6, steps=100,
            learning_rate=5e-3)


def _fns(tcfg_kw):
    jt = jtm.MaterialTrainConfig(**tcfg_kw)
    tt = ttm.MaterialTrainConfig(**tcfg_kw)
    return jt, tt


def _grad_capture():
    """A transformation whose state after an update is the gradient and
    whose update is zero: the JAX step then hands back its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("e_ind,relative", [(False, True), (True, False)])
def test_loss_and_gradients_match_jax(e_ind, relative):
    kw = dict(TCFG, relative_mse=relative, smooth_ks_weight=0.05)
    jt, tt = _fns(kw)
    radiance = np.array([[4.0, 3.0, 2.0]], np.float32)
    jcfg, params, stage = _stage_pair(radiance, seed=1)
    buf = _buffers(e_ind=e_ind)
    tx = _grad_capture()
    jstep, _, _ = jtm.make_material_train_step(
        jcfg, jt, _jsdf, CENTERS, RADII, tx)
    key = jax.random.PRNGKey(7)
    state = TrainState(step=jnp.int32(0), params=params,
                       opt_state=tx.init(params))
    state, jmetrics = jstep(state, {k: jnp.asarray(v)
                                    for k, v in buf.items()}, key)
    _, _, _, loss_fn = ttm.make_material_train_step(
        tt, _tsdf, torch.from_numpy(CENTERS), torch.from_numpy(RADII))
    k_idx, k_loss = JaxDraws(key).split(2)
    idx = k_idx.integers((64,), 400)
    tb = {k: torch.from_numpy(v)[idx] for k, v in buf.items()}
    loss, metrics = loss_fn(stage, k_loss, tb["points"], tb["normals"],
                            tb["view_dirs"], tb["rgb"], tb.get("e_ind"))
    loss.backward()
    for k, v in jmetrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-4), k
    # the dual-buffer product can be negative; the MSE cannot
    assert np.isfinite(float(metrics["loss"])) and metrics["rgb_loss"] > 0
    grads = material_to_jax({k: p.grad for k, p in
                             stage.named_parameters()})
    want = to_numpy(state.opt_state)
    for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(grads),
            jax.tree_util.tree_leaves(want)):
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("e_ind", [False, True])
def test_calibrate_matches_jax(e_ind):
    jt, tt = _fns(TCFG)
    radiance = np.array([[4.0, 3.0, 2.0]], np.float32)
    jcfg, params, stage = _stage_pair(radiance, seed=2)
    buf = _buffers(n=300, seed=1, e_ind=e_ind)
    tx = make_optimizer(5e-3)
    _, _, jcal = jtm.make_material_train_step(jcfg, jt, _jsdf, CENTERS,
                                              RADII, tx)
    _, _, tcal, _ = ttm.make_material_train_step(
        tt, _tsdf, torch.from_numpy(CENTERS), torch.from_numpy(RADII))
    key = jax.random.PRNGKey(11)
    want = jcal(params, {k: jnp.asarray(v) for k, v in buf.items()}, key,
                probe=200)
    before = stage.emission["log_ambient"].detach().clone()
    tcal(stage, {k: torch.from_numpy(v) for k, v in buf.items()},
         JaxDraws(key), probe=200)
    for k in ("log_radiance", "log_ambient"):
        np.testing.assert_allclose(stage.emission[k].detach().numpy(),
                                   np.asarray(want["emission"][k]),
                                   atol=1e-5)
    assert torch.equal(stage.emission["log_ambient"].detach(),
                       before) == e_ind


def test_three_adam_steps_match_jax():
    jt, tt = _fns(TCFG)
    radiance = np.array([[4.0, 3.0, 2.0]], np.float32)
    jcfg, params, stage = _stage_pair(radiance, seed=4)
    buf = _buffers(seed=2)
    lr = TCFG["learning_rate"]
    tx = make_optimizer(lr, 0.1, decay_steps=TCFG["steps"])
    jstep, _, _ = jtm.make_material_train_step(jcfg, jt, _jsdf, CENTERS,
                                               RADII, tx)
    gtx = _grad_capture()
    jgrad, _, _ = jtm.make_material_train_step(jcfg, jt, _jsdf, CENTERS,
                                               RADII, gtx)
    tstep, _, _, _ = ttm.make_material_train_step(
        tt, _tsdf, torch.from_numpy(CENTERS), torch.from_numpy(RADII))
    jstate = TrainState(step=jnp.int32(0), params=params,
                        opt_state=tx.init(params))
    tstate = create_train_state(stage, lr, 0.1, decay_steps=TCFG["steps"])
    jbuf = {k: jnp.asarray(v) for k, v in buf.items()}
    tbuf = {k: torch.from_numpy(v) for k, v in buf.items()}
    p0 = to_numpy(params)
    for t in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(3), t)
        if t == 0:
            g0 = to_numpy(jgrad(TrainState(step=jnp.int32(0), params=params,
                                           opt_state=gtx.init(params)),
                                jbuf, key)[0].opt_state)
        jstate, _ = jstep(jstate, jbuf, key)
        tstep(tstate, tbuf, JaxDraws(key))
        got = material_to_jax(stage.state_dict())
        want = to_numpy(jstate.params)
        for a, b, a0, g in zip(jax.tree_util.tree_leaves(got),
                               jax.tree_util.tree_leaves(want),
                               jax.tree_util.tree_leaves(p0),
                               jax.tree_util.tree_leaves(g0)):
            if t == 0:
                sure = np.abs(g) > 1e-3 * np.abs(g).max()
                np.testing.assert_allclose((a - a0)[sure], (b - a0)[sure],
                                           atol=1e-4 * lr, rtol=0)
                assert np.abs(b - a0).max() <= lr * (1 + 1e-5)
            np.testing.assert_allclose(a, b, atol=3 * lr, rtol=0)
    assert tstate.step == int(jstate.step) == 3
