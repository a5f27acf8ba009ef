"""The port's view interpolation (`i2sdf_tpu_torch/eval/interpolate.py`)
against the JAX package's (`i2sdf_tpu/eval/interpolate.py`), on the CPU:

* `interpolate_poses` equal to the bit (the same scipy `Slerp` and numpy);
* the CLI (`--test_mode interpolate`, `run_interpolation`) writing its
  frames on the tiny scene at narrow widths with converted parameters,
  and a frame against the JAX package's
  `make_eval_render_fn(fused_sampler=False)` at the same pose: the PNGs
  within one level of 255 (the renders agree to 1e-4 in rgb and 1e-3 in
  the normals, `test_torch_slice.py`, and a value at a level's edge can
  round either way).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.eval import interpolate as jinterp
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu.train.step import make_eval_render_fn as jax_eval_render
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.data.plot import PlotData
from i2sdf_tpu_torch.eval import interpolate as tinterp
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.params import from_jax_params
from i2sdf_tpu_torch.utils import imaging
from test_torch_helpers import to_numpy
from test_torch_train_step import write_tiny_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [1, 2, 7, 60])
def test_interpolate_poses_equal_jax(n):
    pd = PlotData("synthetic_quality", scan_id=1,
                  data_root=os.path.join(ROOT, "data"), indices=[0, 5])
    got = tinterp.interpolate_poses(pd.pose_all[0], pd.pose_all[1], n)
    want = jinterp.interpolate_poses(pd.pose_all[0], pd.pose_all[1], n)
    assert got.shape == (n, 4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], pd.pose_all[0], atol=1e-6)
    if n > 1:
        np.testing.assert_allclose(got[-1], pd.pose_all[1], atol=1e-6)


def test_interpolate_cli_frames_match_jax(tmp_path):
    """`--test_mode interpolate --inter_id 1 0 --n_frames 3` on the CPU with
    weights converted from JAX parameters: three RGB and three normal
    frames, no video without ffmpeg; the middle frame against the JAX
    package's eval render at the same pose."""
    conf = write_tiny_scene(str(tmp_path))
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jax_load_cfg(conf).model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(conf).model)
    params = jrenderer.init(jax.random.PRNGKey(0), jcfg)
    pt = str(tmp_path / "model.pt")
    torch.save(from_jax_params(to_numpy(params), tcfg), pt)
    assert tmain.main([
        "--conf", conf, "--device", "cpu", "--data_root", str(tmp_path),
        "--exps_folder", str(tmp_path / "exps"), "--test", "--test_mode",
        "interpolate", "--inter_id", "1", "0", "--n_frames", "3",
        "--frame_rate", "12", "--ckpt", pt]) == 0
    out = (tmp_path / "exps" / "quality_0" / "version_0" / "eval"
           / "interpolate")
    frames = out / "0001_0000"
    want = ["0000.png", "0001.png", "0002.png"]
    assert sorted(os.listdir(frames)) == want
    assert sorted(os.listdir(out / "0001_0000_normal")) == want
    videos = sorted(f for f in os.listdir(out) if f.endswith(".mp4"))
    assert videos == ([] if shutil.which("ffmpeg") is None else
                      ["scan0_0001_0000.mp4", "scan0_0001_0000_normal.mp4"])

    pd = PlotData("tiny", scan_id=0, data_root=str(tmp_path), indices=[1, 0])
    pose = jinterp.interpolate_poses(pd.pose_all[0], pd.pose_all[1], 3)[1]
    render, _ = jax_eval_render(jcfg, chunk_size=768, fused_sampler=False)
    ref = render(params, jnp.asarray(pd.uv),
                 jnp.asarray(pd.intrinsics_all[0]), jnp.asarray(pose))
    H, W = pd.img_res
    rgb = imaging.to_u8(np.asarray(ref["rgb_values"]).reshape(H, W, 3))
    n_cam = np.asarray(ref["normal_map"]).reshape(H, W, 3) @ pose[:3, :3]
    normal = imaging.to_u8((n_cam + 1.0) / 2.0)
    for got, want in ((imaging.read_png(str(frames / "0001.png")), rgb),
                      (imaging.read_png(str(out / "0001_0000_normal"
                                            / "0001.png")), normal)):
        assert got.shape == want.shape == (H, W, 3)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and diff.mean() < 0.05
