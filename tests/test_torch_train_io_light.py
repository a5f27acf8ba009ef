"""The light-mask config's host side against the JAX package, on the
CPU: light masks in `ReconData`, the batch and `PlotData` against the
JAX loaders (exactly), `train.flip_light`, the parameter converter with
a light net, its checkpoint and resume, and both CLIs, on the tiny scene
with seeded grey light masks (`test_torch_train_step.write_light_scene`)
written to `tmp_path`. A file of its own, beside `test_torch_train_io.py`,
so that the suite's workers (`--dist loadfile`) run them side by side.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from i2sdf_tpu.data.recon import ReconData as JReconData
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.data.recon import ReconData
from i2sdf_tpu_torch.train.checkpoint import CheckpointManager
from i2sdf_tpu_torch.train.trainer import ReconstructionTrainer
from i2sdf_tpu_torch.utils import imaging
from test_torch_train_io import _recon_equal
from test_torch_train_step import write_light_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_light_masks_load_as_jax_loads_them(tmp_path):
    """`ReconData`'s light masks (grey PNGs scaled as `load_mask`), the
    batch's target, and `PlotData`'s masks from the training data's arrays,
    indexed and downsampled with the images, against the JAX package's
    loaders. From disk `PlotData` reads no light masks, as JAX's does
    not."""
    from i2sdf_tpu.data.plot import PlotData as JPlotData
    from i2sdf_tpu_torch.data.plot import PlotData
    from i2sdf_tpu_torch.data.recon import sample_batch
    write_light_scene(str(tmp_path))
    kw = dict(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
              use_depth=True, use_normal=True, use_lightmask=True)
    got, ref = ReconData(**kw), JReconData(**kw)
    _recon_equal(got, ref)
    assert got.use_lightmask and ref.use_lightmask
    np.testing.assert_array_equal(got.lightmask_images, ref.lightmask_images)
    assert got.lightmask_images.shape == (2, 24 * 32, 1)
    assert set(np.unique(got.lightmask_images)) == {0.0, 1.0}
    d = got.to_device("cpu")
    _, gt = sample_batch(d, torch.tensor([3, 24 * 32 + 9]))
    np.testing.assert_array_equal(
        gt["light_mask"].numpy(),
        got.lightmask_images[[0, 1], [3, 9]])
    off = ReconData(**{**kw, "use_lightmask": False})
    assert off.lightmask_images is None and off.to_device("cpu").light_mask \
        is None
    handoff = {"intrinsics": got.intrinsics_all, "pose": got.pose_all,
               "rgb": got.rgb_images, "img_res": got.img_res,
               "light_mask": got.lightmask_images}
    names = ("rgb_images", "intrinsics_all", "pose_all", "uv")
    masks = []
    for tp, jp in (
            (PlotData(data=handoff, downsample=2, indices=[1]),
             JPlotData(data=handoff, downsample=2, indices=[1])),
            (PlotData("tiny", 0, str(tmp_path), downsample=2, indices=[1]),
             JPlotData("tiny", 0, str(tmp_path), downsample=2,
                       indices=[1]))):
        assert tp.img_res == jp.img_res == [12, 16]
        for name in names:
            np.testing.assert_allclose(getattr(tp, name), getattr(jp, name),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        masks.append((tp.lightmask_images, jp.lightmask_images))
    (hand, jhand), (disk, jdisk) = masks
    assert hand.shape == (1, 12 * 16, 1)
    np.testing.assert_allclose(hand, jhand, rtol=1e-6, atol=1e-6)
    assert disk is None and jdisk is None


def _light_trainer(tmp_path, exp="exp", flip=False):
    conf = load_cfg(write_light_scene(str(tmp_path)))
    conf.train.plot_freq = 1000
    conf.train.flip_light = flip
    return ReconstructionTrainer(conf, str(tmp_path / exp),
                                 data_root=str(tmp_path), device="cpu",
                                 seed=3)


def test_flip_light_inverts_train_and_plot_masks(tmp_path):
    """`train.flip_light` (JAX `trainer.py:196-205`): the training and
    validation light masks become 1 - mask."""
    tr = _light_trainer(tmp_path / "a")
    fl = _light_trainer(tmp_path / "b", flip=True)
    assert tr.model_cfg.use_light and tr.train_data.use_lightmask
    for a, b in ((tr.train_data.lightmask_images,
                  fl.train_data.lightmask_images),
                 (tr.device_data.light_mask.numpy(),
                  fl.device_data.light_mask.numpy()),
                 (tr.plot_data.lightmask_images,
                  fl.plot_data.lightmask_images)):
        np.testing.assert_array_equal(b, 1.0 - a)
    assert tr.plot_data.lightmask_images.shape == (2, 24 * 32, 1)


def test_params_convert_with_a_light_net():
    """`from_jax_params` / `to_jax_params` carry the light net: the JAX
    package's init of the light-mask config into the port's model and
    back, leaf for leaf."""
    import jax
    from i2sdf_tpu.config import load_cfg as jax_load_cfg
    from i2sdf_tpu.models import renderer as jrenderer
    from i2sdf_tpu_torch.models import renderer
    from i2sdf_tpu_torch.params import from_jax_params, to_jax_params
    path = os.path.join(ROOT, "configs", "synthetic_light_mask.yml")
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jax_load_cfg(path).model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(path).model)
    assert tcfg.light.layer_dims() == jcfg.light.layer_dims() == [256, 128,
                                                                  1]
    tree = jax.tree_util.tree_map(np.asarray,
                                  jrenderer.init(jax.random.PRNGKey(0), jcfg))
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(tree, tcfg))
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "implicit", "rendering", "light", "beta"}
    back = to_jax_params(model.state_dict())
    assert set(back) == set(tree)
    for net in ("implicit", "rendering", "light"):
        for lin, leaves in tree[net].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(back[net][lin][leaf], v)
    with pytest.raises(KeyError):
        no_light = {k: v for k, v in tree.items() if k != "light"}
        from_jax_params(no_light, tcfg)


def test_light_checkpoint_round_trip_and_resume(tmp_path):
    """The light net and its Adam moments go into the checkpoint; a run
    resumed from it ends where an uninterrupted one does."""
    tr = _light_trainer(tmp_path / "a")
    tr.fit(max_steps=2, log_every=10)
    ckpt = CheckpointManager(str(tmp_path / "a" / "exp" / "checkpoints"))
    payload = torch.load(ckpt.path(2), weights_only=True)
    assert any(k.startswith("light.") for k in payload["model"])
    light = {id(p) for p in tr.state.model.light.parameters()}
    n_light = sum(1 for g in tr.state.optimizer.param_groups
                  for p in g["params"] if id(p) in light)
    assert n_light == 6 and len(payload["optimizer"]["state"]) == len(
        list(tr.state.model.parameters()))
    shutil.copytree(ckpt.ckpt_dir, tmp_path / "saved")
    tr3 = _light_trainer(tmp_path / "c")
    tr3.ckpt = CheckpointManager(str(tmp_path / "saved"))
    tr3.fit(max_steps=3, resume=True, log_every=10)
    tr.fit(max_steps=3, log_every=10)
    assert tr3.state.step == tr.state.step == 3
    for (k, a), (_, b) in zip(tr.state.model.state_dict().items(),
                              tr3.state.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa = tr.state.optimizer.state_dict()["state"]
    sb = tr3.state.optimizer.state_dict()["state"]
    for i in sa:
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)


def test_light_clis_on_cpu(tmp_path, capsys):
    """The train CLI on the light-mask config's shape for 2 steps (the
    light-mask term in its logs, a light-mask plot from its validation),
    then the render CLI on its newest checkpoint."""
    conf = write_light_scene(str(tmp_path))
    args = ["--conf", conf, "--device", "cpu", "--data_root", str(tmp_path),
            "--exps_folder", str(tmp_path / "exps"), "--log_every", "1"]
    assert tmain.main(args + ["--max_steps", "2"]) == 0
    logs = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[scan0 ")]
    assert len(logs) == 2 and all("light_mask=" in ln for ln in logs), logs
    exp = tmp_path / "exps" / "quality_0" / "version_0"
    plots = sorted(os.listdir(exp / "plots" / "light_mask"))
    assert len(plots) == 1 and plots[0].startswith("2_")
    lm = imaging.read_png(str(exp / "plots" / "light_mask" / plots[0]))
    assert lm.shape == (24, 32, 3)   # MAGMA-colormapped, as the JAX plot
    assert tmain.main(args + ["--test", "--indices", "1"]) == 0
    out = capsys.readouterr().out
    assert "[INFO] restored checkpoint @2" in out
    depth = np.load(exp / "eval" / "depth" / "0001.npy")
    assert depth.shape == (24, 32) and np.isfinite(depth).all()
