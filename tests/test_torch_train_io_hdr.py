"""The trainer and the train CLI on the last slice's data and artifacts,
on the CPU, on the tiny HDR scene of `test_torch_data_io.py` (HDR `.npy`
images, object masks, `val/`; depth, normals and the bubble window from
`test_torch_train_step.py`'s tiny scene):

* the train CLI with `--is_val` and `--profile 0:1` for 2 steps: the mask
  term in the logs, validation in display space with the proxy LPIPS
  (`lpips-rf-torch`), the linear prediction under `plots/hdr/`, the
  colormapped plots, the bubble's `pointcloud.html` and its hot and count
  maps (one PNG an image) from the pdf's initialization, and a Chrome
  trace of step 0 under `profile/` (on the CPU the plain versions run,
  so it holds the step's range and no kernel's; the smoke checks the
  kernels' on the card);
* the same with `--no_fused` (on the CPU the plain versions run either
  way): the same losses to the bit;
* the validation's HDR display transform against the JAX trainer's,
  `linear_to_srgb(clip(., 0, 1))` (`trainer.py:585-590`).
"""

import json
import os
import re

import numpy as np

from i2sdf_tpu.utils import imaging as jimaging
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.utils import imaging
from test_torch_data_io import _io_scene


def _conf(tmp_path):
    _io_scene(str(tmp_path))
    path = os.path.join(str(tmp_path), "tiny.yml")
    text = (open(path).read()
            .replace("dataset:\n", "dataset:\n    is_hdr: true\n")
            .replace("loss:\n", "loss:\n    mask_weight: 0.1\n"))
    with open(path, "w") as f:
        f.write(text)
    return path


def test_train_cli_hdr_masks_val_profile(tmp_path, capsys):
    conf = _conf(tmp_path)
    logs = {}
    for name, extra in (("default", ["--profile", "0:1"]),
                        ("no_fused", ["--no_fused"])):
        exps = str(tmp_path / f"exps_{name}")
        assert tmain.main(["--conf", conf, "--device", "cpu", "--data_root",
                           str(tmp_path), "--exps_folder", exps,
                           "--log_every", "1", "--max_steps", "2",
                           "--is_val"] + extra) == 0
        out = capsys.readouterr().out
        logs[name] = [ln for ln in out.splitlines()
                      if ln.startswith("[scan0 ")]
        assert len(logs[name]) == 2
        assert all(" mask=" in ln for ln in logs[name]), logs[name]
        val = [ln for ln in out.splitlines() if ln.startswith("[val @2]")]
        assert val and "lpips-rf-torch=" in val[0], out[-2000:]
        exp = os.path.join(exps, "quality_0", "version_0")
        assert os.path.isfile(os.path.join(exp, "plots", "hdr", "2_0.npy")
                              ) or os.path.isfile(
            os.path.join(exp, "plots", "hdr", "2_1.npy"))
        assert os.path.isfile(os.path.join(exp, "pointcloud.html"))
        for sub in ("hotmap", "countmap"):
            pngs = sorted(os.listdir(os.path.join(exp, sub)))
            assert pngs == ["0000.png", "0001.png"], (sub, pngs)
            img = imaging.read_png(os.path.join(exp, sub, pngs[0]))
            assert img.shape == (24, 32, 3)
        if name == "default":
            traces = os.listdir(os.path.join(exp, "profile"))
            assert traces == ["trace_0_1.json"], traces
            trace = json.load(open(os.path.join(exp, "profile", traces[0])))
            names = {e.get("name") for e in trace["traceEvents"]}
            assert "train/step_0" in names and "train/step_1" not in names
        else:
            assert not os.path.exists(os.path.join(exp, "profile"))
    # the same losses, the rates aside
    strip = lambda ls: [re.sub(r"\(.*rays/s\)", "", ln)  # noqa: E731
                        for ln in ls]
    assert strip(logs["default"]) == strip(logs["no_fused"])


def test_hdr_display_transform_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 3.0, (6, 7, 3)).astype(np.float32)
    got = imaging.linear_to_srgb(np.clip(x, 0, 1))
    want = np.asarray(jimaging.linear_to_srgb(np.clip(x, 0, 1)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.min() >= 0 and got.max() <= 1.0 + 1e-6
