"""The port's train and render CLI against their own checkpoints, on the
CPU (`--device cpu`), on the tiny scene of `test_torch_train_step.py`
written to `tmp_path`: the train CLI for 2 steps, a resume and a new
version; the render CLI loading the experiment's newest checkpoint (or
the one `--ckpt` names, and exiting non-zero where there is none); the
experiment's version taken from the `--conf` path; and the train CLI
with the normal losses off. A file of their own, beside
`test_torch_train_io.py`, so that the suite's workers (`--dist
loadfile`) run them side by side.
"""

import json
import os
import shutil

import pytest
import torch

from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from test_torch_train_step import write_tiny_scene


def test_train_cli_on_cpu(tmp_path):
    conf = write_tiny_scene(str(tmp_path))
    args = ["--conf", conf, "--device", "cpu", "--data_root", str(tmp_path),
            "--exps_folder", str(tmp_path / "exps"), "--log_every", "1"]
    assert tmain.main(args + ["--max_steps", "2"]) == 0
    exp = tmp_path / "exps" / "quality_0" / "version_0"
    ckpts = lambda: sorted(  # noqa: E731
        f for f in os.listdir(exp / "checkpoints") if f.endswith(".pt"))
    assert ckpts() == ["step_2.pt"]
    assert (exp / "checkpoints" / "pdf.npy").is_file()  # bubble window
    assert (exp / "plots" / "rendering").is_dir()
    assert tmain.main(args + ["--max_steps", "3", "--resume"]) == 0
    assert ckpts() == ["step_2.pt", "step_3.pt"]
    assert tmain.main(args + ["--max_steps", "1"]) == 0  # a new version
    assert (tmp_path / "exps" / "quality_0" / "version_1").is_dir()


def test_render_cli_loads_the_experiments_checkpoint(tmp_path, monkeypatch):
    """`--test` with no `--ckpt` renders the newest `step_N.pt` of the
    experiment, `--ckpt N` step N, and with no checkpoint the CLI exits
    non-zero instead of rendering the seeded init."""
    conf = write_tiny_scene(str(tmp_path))
    args = ["--conf", conf, "--device", "cpu", "--data_root", str(tmp_path),
            "--exps_folder", str(tmp_path / "exps"), "--log_every", "1"]
    assert tmain.main(args + ["--max_steps", "1"]) == 0
    assert tmain.main(args + ["--max_steps", "2", "--resume"]) == 0
    ckpt_dir = tmp_path / "exps" / "quality_0" / "version_0" / "checkpoints"
    rendered = []
    monkeypatch.setattr(tmain, "run_render_eval",
                        lambda model, *a, **k: rendered.append(model))
    for extra, step in (([], 2), (["--ckpt", "latest"], 2),
                        (["--ckpt", "1"], 1)):
        assert tmain.main(args + ["--test", "--indices", "0"] + extra) == 0
        want = torch.load(ckpt_dir / f"step_{step}.pt",
                          weights_only=True)["model"]
        got = rendered[-1].state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (step, k)
    for bad in (["--ckpt", "7"], ["--ckpt", "best"],
                ["--exps_folder", str(tmp_path / "none")]):
        with pytest.raises(SystemExit) as exc:
            tmain.main(args + ["--test"] + bad)
        assert exc.value.code not in (0, None), bad
    assert len(rendered) == 3


def test_exp_dir_takes_the_version_in_the_conf_path(tmp_path):
    """As the JAX CLI does (`i2sdf_tpu/main.py:112-115`), a `version_N` in
    the `--conf` path names the experiment's version."""
    src = write_tiny_scene(str(tmp_path))
    vdir = tmp_path / "exps" / "quality_0" / "version_3"
    vdir.mkdir(parents=True)
    (tmp_path / "exps" / "quality_0" / "version_5").mkdir()
    conf = vdir / "tiny.yml"
    conf.write_text(open(src).read())
    for extra in ([], ["--test"], ["--resume"]):
        args = tmain.build_argparser().parse_args(
            ["--conf", str(conf), "--exps_folder", str(tmp_path / "exps")]
            + extra)
        got = tmain.resolve_exp_dir(args, load_cfg(str(conf)),
                                    new_version=not extra)
        assert got == str(vdir), extra
    args = tmain.build_argparser().parse_args(
        ["--conf", src, "--exps_folder", str(tmp_path / "exps")])
    assert tmain.resolve_exp_dir(args, load_cfg(src)).endswith("version_5")


def test_train_cli_normal_off_on_cpu(tmp_path, capsys):
    """The train CLI on a copy of the config with `normal_weight: 0` and a
    scene without normal maps: the model leaves the normals out, the loader
    reads none, and the logged loss carries no normal term."""
    conf = write_tiny_scene(str(tmp_path))
    shutil.rmtree(tmp_path / "tiny" / "scan0" / "normal")
    text = open(conf).read()
    assert "normal_weight: 0.05" in text
    nonormal = tmp_path / "nonormal.yml"
    nonormal.write_text(text.replace("normal_weight: 0.05",
                                     "normal_weight: 0.0"))
    args = ["--conf", str(nonormal), "--device", "cpu", "--data_root",
            str(tmp_path), "--exps_folder", str(tmp_path / "exps"),
            "--log_every", "1", "--max_steps", "2"]
    assert tmain.main(args) == 0
    logs = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[scan0 ")]
    assert len(logs) == 2 and not any(
        t in ln for ln in logs for t in ("normal=", "angular=")), logs
    exp = tmp_path / "exps" / "quality_0" / "version_0"
    payload = torch.load(exp / "checkpoints" / "step_2.pt",
                         weights_only=True)
    assert payload["step"] == 2
    with open(exp / "config.json") as f:
        assert json.load(f)["model"]["use_normal"] is False
