"""The port's first slice as a whole: the eval render of the flagship model.

* `render_rays` against the JAX package's
  `renderer.render_rays(training=False, fused_sampler=False)` on the same
  converted parameters and rays, both on the CPU in f32: rgb to 1e-4,
  depth and normal to 1e-3 (the two sum in different orders and the
  reference's prefix sums are hi/lo-split bf16 matmuls; earlier
  cross-framework work reached 1.2e-7 on rgb,
  docs/evidence/crossfw_parity.json);
* the weight converter, the camera and data path, and the render CLI on
  the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.data.plot import PlotData as JaxPlotData
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu.utils import cameras as jcameras
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.data.plot import PlotData
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.params import from_jax_params, load_model, to_jax_params
from i2sdf_tpu_torch.utils import cameras, imaging
from test_torch_helpers import to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "configs", "synthetic.yml")
DATA = os.path.join(ROOT, "data")


def _narrow(conf):
    m = conf.model
    m.feature_vector_size = 32
    m.implicit_network.dims = [64] * 4
    m.implicit_network.skip_in = [2]
    m.rendering_network.dims = [64] * 2
    return conf


def _pair(narrow: bool):
    jc, tc = jax_load_cfg(CONF), load_cfg(CONF)
    if narrow:
        _narrow(jc), _narrow(tc)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jc.model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(tc.model)
    params = jrenderer.init(jax.random.PRNGKey(0), jcfg)
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(to_numpy(params), tcfg))
    return jcfg, params, model


def render_rays_against_jax(narrow: bool, n_rays: int):
    jcfg, params, model = _pair(narrow)
    pd = PlotData("synthetic_quality", scan_id=1, data_root=DATA,
                  downsample=2, indices=[0])
    uv, K, pose, _ = pd.image_inputs(0)
    sel = np.random.default_rng(0).choice(len(uv), n_rays, replace=False)
    inputs = {"uv": uv[sel][None], "intrinsics": K[None], "pose": pose[None]}
    ref = jax.jit(lambda p, i: jrenderer.render_rays(
        p, jcfg, i, jax.random.PRNGKey(0), training=False,
        fused_sampler=False))(params, {k: jnp.asarray(v)
                                       for k, v in inputs.items()})
    got = renderer.render_rays(model, {k: torch.from_numpy(v)
                                       for k, v in inputs.items()})
    for key, tol in (("rgb_values", 1e-4), ("depth_values", 1e-3),
                     ("normal_map", 1e-3), ("weight_sum", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=tol, err_msg=key)


def test_render_rays_matches_jax_narrow():
    """SDF 4x64, radiance 2x64, 32 features, the flagship sampler."""
    render_rays_against_jax(narrow=True, n_rays=64)


def test_converter_round_trip_and_checks():
    jcfg, params, model = _pair(True)
    tree = to_numpy(params)
    back = to_jax_params(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    tcfg = model.cfg
    bad = dict(tree, implicit=dict(tree["implicit"]))
    bad["implicit"]["lin0"] = {k: v[:-1] for k, v in
                               tree["implicit"]["lin0"].items()}
    with pytest.raises(ValueError):
        from_jax_params(bad, tcfg)


def test_cameras_and_plot_data_match_jax():
    pd = PlotData("synthetic_quality", scan_id=1, data_root=DATA,
                  downsample=2, indices=[0, 3])
    ref = JaxPlotData(data_dir="synthetic_quality", scan_id=1,
                      data_root=DATA, downsample=2, indices=[0, 3])
    assert pd.img_res == list(ref.img_res) == [240, 320]
    np.testing.assert_allclose(pd.intrinsics_all, ref.intrinsics_all,
                               rtol=1e-6)
    np.testing.assert_allclose(pd.pose_all, ref.pose_all, atol=1e-6)
    np.testing.assert_allclose(pd.rgb_images, ref.rgb_images, atol=1e-6)
    np.testing.assert_array_equal(pd.uv, ref.uv)
    uv = pd.uv[None, ::97]
    d, c = cameras.get_camera_params(torch.from_numpy(uv),
                                     torch.from_numpy(pd.pose_all[:1]),
                                     torch.from_numpy(pd.intrinsics_all[:1]))
    dr, cr = jcameras.get_camera_params(uv, pd.pose_all[:1],
                                        pd.intrinsics_all[:1])
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(cr), atol=1e-6)
    dn = torch.nn.functional.normalize(d[0], dim=-1)
    s, m = cameras.get_sphere_intersections(c.expand(dn.shape[0], 3), dn, 3.0)
    sr, mr = jcameras.get_sphere_intersections(
        np.broadcast_to(np.asarray(cr), dn.shape), dn.numpy(), 3.0)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=1e-5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mr))


def _tiny_scene(root, n_views=2, shrink=20):
    """Two views of scan1, shrunk 20x (24 x 32 pixels), intrinsics
    rescaled through the projection matrices."""
    src = os.path.join(DATA, "synthetic_quality", "scan1")
    dst = os.path.join(root, "tiny", "scan0")
    os.makedirs(os.path.join(dst, "image"))
    cams = np.load(os.path.join(src, "cameras_normalize.npz"))
    out = {}
    for i in range(n_views):
        img = imaging.read_png(os.path.join(src, "image", f"{i:04d}.png"))
        small = imaging.downsample_area(img.astype(np.float32), shrink)
        imaging.write_png(os.path.join(dst, "image", f"{i:04d}.png"),
                          np.round(small).astype(np.uint8))
        wm = cams[f"world_mat_{i}"].copy()
        wm[:2] /= shrink
        out[f"world_mat_{i}"] = wm
        out[f"scale_mat_{i}"] = cams[f"scale_mat_{i}"]
    np.savez(os.path.join(dst, "cameras_normalize.npz"), **out)


def test_render_cli_on_cpu(tmp_path):
    _tiny_scene(str(tmp_path))
    text = open(CONF).read()
    text = (text.replace("dims: [256, 256, 256, 256, 256, 256, 256, 256]",
                         "dims: [48, 48, 48, 48]")
            .replace("skip_in: [4]", "skip_in: [2]")
            .replace("dims: [256, 256, 256, 256]", "dims: [32, 32]")
            .replace("feature_vector_size: 256", "feature_vector_size: 16")
            .replace("data_dir: synthetic", "data_dir: tiny")
            .replace("downsample: 2", "downsample: 1")
            .replace("round_eval_counts: [128, 128, 96, 64, 64]",
                     "round_eval_counts: [32, 16, 16]")
            .replace("max_total_iters: 5", "max_total_iters: 3")
            .replace("N_samples: 64", "N_samples: 16")
            .replace("N_samples_extra: 32", "N_samples_extra: 8")
            .replace("split_n_pixels: 12000", "split_n_pixels: 500"))
    conf = tmp_path / "tiny.yml"
    conf.write_text(text)
    torch.save(renderer.I2SDFModel(renderer.I2SDFConfig.from_cfgnode(
        load_cfg(str(conf)).model), seed=5).state_dict(),
        tmp_path / "model.pt")
    rc = tmain.main(["--conf", str(conf), "--test", "--test_mode", "render",
                     "--device", "cpu", "--data_root", str(tmp_path),
                     "--exps_folder", str(tmp_path / "exps"),
                     "--ckpt", str(tmp_path / "model.pt")])
    assert rc == 0
    out = tmp_path / "exps" / "synthetic_0" / "version_0" / "eval"
    for name in ("rendering/0000_pred.png", "rendering/0001.png",
                 "depth/0001.npy", "depth/0000.png", "normal/0000.npy",
                 "normal/0001w.npy", "normal/0000.png", "metrics.txt"):
        assert (out / name).is_file(), name
    pred = imaging.read_png(str(out / "rendering" / "0000_pred.png"))
    assert pred.shape == (24, 32, 3)
    depth = np.load(out / "depth" / "0001.npy")
    assert depth.shape == (24, 32) and np.isfinite(depth).all()
    lines = (out / "metrics.txt").read_text().splitlines()
    assert lines[-1].startswith("[MEAN] [PSNR]") and len(lines) == 5
    assert lines[1].startswith("# LPIPS implementation: lpips-rf-torch")
    with pytest.raises(SystemExit):
        tmain.main(["--conf", str(conf), "--test", "--test_mode", "mesh",
                    "--device", "cpu"])
    model = load_model(renderer.I2SDFConfig.from_cfgnode(
        load_cfg(str(conf)).model), str(tmp_path / "model.pt"), 0, "cpu")
    ref = renderer.I2SDFModel(model.cfg, seed=5)
    assert torch.equal(model.implicit.lin0.v, ref.implicit.lin0.v)
