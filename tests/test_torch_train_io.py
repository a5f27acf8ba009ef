"""The training slice's host side against the JAX package, on the CPU:

* the EXR reader (`utils/exr.py`) against the JAX package's native writer
  and reader (FLOAT and HALF, one to four channels, ZIP and none), and the
  depth and normal loaders against the JAX package's on scan1's files;
* `ReconData` against the JAX loader (depth scaling and validity, world
  normals, the bubble point cloud and its links), exactly;
* the losses and their weight schedule, to f32 rounding (1e-6);
* both learning-rate schedules and Adam (eps 1e-15) against optax, to f32
  rounding (1e-6 relative);
* checkpoint round trip, resume (a resumed run equals an uninterrupted
  one), and the train CLI for 2 steps with `--device cpu`.
"""

import glob
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from i2sdf_tpu import native
from i2sdf_tpu.data.recon import ReconData as JReconData
from i2sdf_tpu.models import losses as jlosses
from i2sdf_tpu.train import state as jstate
from i2sdf_tpu.utils import imaging as jimaging
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.data.recon import ReconData
from i2sdf_tpu_torch.models import losses
from i2sdf_tpu_torch.train import state as tstate
from i2sdf_tpu_torch.train.checkpoint import CheckpointManager
from i2sdf_tpu_torch.train.trainer import ReconstructionTrainer
from i2sdf_tpu_torch.utils import imaging
from i2sdf_tpu_torch.utils.exr import read_exr
from test_torch_train_step import write_tiny_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN1 = os.path.join(ROOT, "data", "synthetic_quality", "scan1")


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("compression", ["zip", "none"])
def test_exr_reader_matches_native(tmp_path, half, channels, compression):
    rng = np.random.default_rng(channels)
    data = rng.normal(size=(37, 41, channels)).astype(np.float32) * 3
    data[0, 0] = np.inf
    path = str(tmp_path / "x.exr")
    native.exr_write(path, data[..., 0] if channels == 1 else data,
                     half=half, compression=compression)
    got, names = read_exr(path)
    ref, ref_names = native.exr_read(path)
    assert names == ref_names
    np.testing.assert_array_equal(got, ref)


def test_depth_and_normal_loaders_match_jax(tmp_path):
    paths = (sorted(glob.glob(os.path.join(SCAN1, "depth", "*.exr")))[:2]
             + sorted(glob.glob(os.path.join(SCAN1, "normal", "*.exr")))[:2])
    if not paths:
        pytest.skip("scan1's depth and normal maps are not in this checkout")
    for p in paths:
        if "depth" in p:
            np.testing.assert_array_equal(imaging.load_depth(p),
                                          jimaging.load_depth(p))
        else:
            np.testing.assert_array_equal(imaging.load_normal(p),
                                          jimaging.load_normal(p))
    a = np.random.default_rng(0).normal(size=(5, 6, 3)).astype(np.float32)
    np.save(tmp_path / "n.npy", a)
    for fn, jfn in ((imaging.load_depth, jimaging.load_depth),
                    (imaging.load_normal, jimaging.load_normal)):
        np.testing.assert_array_equal(fn(str(tmp_path / "n.npy")),
                                      jfn(str(tmp_path / "n.npy")))


def _recon_equal(got: ReconData, ref: JReconData):
    for name in ("intrinsics_all", "pose_all", "rgb_images", "uv",
                 "depth_images", "depth_masks", "normal_images",
                 "normal_masks", "pointcloud", "pointlinks", "pixlinks"):
        g, r = getattr(got, name), getattr(ref, name)
        assert (g is None) == (r is None), name
        if g is not None:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    assert got.img_res == ref.img_res and got.n_images == ref.n_images


def test_recon_data_matches_jax(tmp_path):
    write_tiny_scene(str(tmp_path))
    kw = dict(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
              use_depth=True, use_normal=True, use_bubble=True)
    got, ref = ReconData(**kw), JReconData(**kw)
    _recon_equal(got, ref)
    assert (got.pointlinks < 0).any() and not got.normal_masks.all()
    d = got.to_device("cpu")
    from i2sdf_tpu_torch.data.recon import sample_batch
    idx = torch.tensor([0, 5, 24 * 32 + 7])
    inputs, gt = sample_batch(d, idx)
    assert inputs["uv"].shape == (3, 1, 2) and gt["depth"].shape == (3,)
    torch.testing.assert_close(gt["rgb"][2], d.rgb[1, 7])
    # a missing modality is switched off, as the JAX loader does
    none = ReconData(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
                     use_depth=False, use_normal=False)
    assert none.depth_images is None and none.normal_images is None


def test_recon_data_matches_jax_on_scan1():
    if not os.path.isdir(os.path.join(SCAN1, "depth")):
        pytest.skip("scan1's depth maps are not in this checkout")
    kw = dict(data_dir="synthetic_quality", scan_id=1,
              data_root=os.path.join(ROOT, "data"), use_depth=True,
              use_normal=True, use_bubble=True)
    _recon_equal(ReconData(**kw), JReconData(**kw))


def _loss_inputs(n=50, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    nrm = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa
    out = {"rgb_values": rng.uniform(size=(n, 3)).astype(np.float32),
           "grad_theta": f(2 * n, 3), "diff_norm": np.abs(f(n)),
           "depth_values": np.abs(f(n)), "weight_sum": rng.uniform(
               size=(n, 1)).astype(np.float32),
           "normal_values": nrm(f(n, 3)), "surface_sdf": f(n, 1)}
    gt_n = nrm(f(n, 3))
    gt_n[3] = np.nan
    gt = {"rgb": rng.uniform(size=(n, 3)).astype(np.float32),
          "depth": np.abs(f(n)), "depth_mask": rng.uniform(size=n) > 0.2,
          "normal": gt_n, "normal_mask": np.arange(n) != 3}
    return out, gt


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("step", [0, 60, 200])
def test_losses_match_jax(bug, step):
    kw = dict(smooth_weight=0.01, smooth_iter=50, bubble_weight=0.5,
              min_bubble_iter=50, max_bubble_iter=100, angular_weight=0.3,
              angular_reference_bug=bug)
    cfg, jcfg = losses.LossConfig(**kw), jlosses.LossConfig(**kw)
    assert cfg.smooth_iter == jcfg.smooth_iter == 100
    w = cfg.dynamic_weights(step)
    jw = jcfg.dynamic_weights(step)
    assert w == {k: float(np.float32(v)) for k, v in jw.items()} or all(
        np.float32(w[k]) == jw[k] for k in jw)
    out, gt = _loss_inputs()
    got = losses.compute_losses({k: torch.from_numpy(v) for k, v in
                                 out.items()},
                                {k: torch.from_numpy(np.asarray(v)) for k, v
                                 in gt.items()}, w, bug)
    ref = jlosses.compute_losses(out, gt, jw, bug)
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6,
                                              abs=1e-7), k


def test_lr_schedules_and_adam_match_optax():
    sched = tstate.make_lr_schedule(5e-4, 0.1, 1000)
    ref = jstate.make_lr_schedule(5e-4, 0.1, 1000)
    for t in (0, 1, 7, 500, 1000, 1500):
        assert sched(t) == pytest.approx(float(ref(t)), rel=1e-6)
    args = (5e-4, 0.1, 32, 76_800, 1600)
    sched_r = tstate.make_reference_lr_schedule(*args)
    ref_r = jstate.make_reference_lr_schedule(*args)
    for t in (0, 1535, 1536, 20_000, 199_999):
        assert sched_r(t) == pytest.approx(float(ref_r(t)), rel=1e-6)
    # Adam with the schedule: step t uses schedule(t) from t = 0
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    model = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
    st = tstate.create_train_state(model, schedule=sched)
    tx = optax.adam(ref, eps=1e-15)
    p, opt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for g in grads:
        model.weight.grad = torch.from_numpy(g)
        st.apply_gradients()
        upd, opt = tx.update(jnp.asarray(g), opt, p)
        p = optax.apply_updates(p, upd)
    assert st.step == 3
    np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(p),
                               rtol=1e-6, atol=1e-9)


def _tiny_trainer(tmp_path, exp="exp"):
    conf = load_cfg(write_tiny_scene(str(tmp_path)))
    conf.loss.min_bubble_iter = 1
    conf.loss.max_bubble_iter = 3
    conf.train.plot_freq = 1000
    return ReconstructionTrainer(conf, str(tmp_path / exp),
                                 data_root=str(tmp_path), device="cpu",
                                 seed=3)


def test_checkpoint_round_trip_and_resume(tmp_path):
    tr = _tiny_trainer(tmp_path / "a")
    tr.fit(max_steps=2, log_every=10)  # bubble window open at step 1
    assert tr.bubble is not None
    ckpt = CheckpointManager(str(tmp_path / "a" / "exp" / "checkpoints"))
    assert ckpt.steps() == [2]
    shutil.copytree(ckpt.ckpt_dir, tmp_path / "saved")
    # round trip into a fresh trainer
    tr2 = _tiny_trainer(tmp_path / "b")
    restored = ckpt.restore(tr2.state)
    assert tr2.state.step == 2
    for (k, a), (_, b) in zip(tr.state.model.state_dict().items(),
                              tr2.state.model.state_dict().items()):
        assert torch.equal(a, b), k
    torch.testing.assert_close(restored["pdf"], tr.bubble.pdf)
    assert torch.equal(restored["sample_count"], tr.bubble.sample_count)
    # a resumed run (bubble pdf restored) ends where an uninterrupted one
    # does
    tr3 = _tiny_trainer(tmp_path / "c")
    tr3.ckpt = CheckpointManager(str(tmp_path / "saved"))
    tr3.fit(max_steps=3, resume=True, log_every=10)
    tr.fit(max_steps=3, log_every=10)
    assert tr3.state.step == tr.state.step == 3
    for (k, a), (_, b) in zip(tr.state.model.state_dict().items(),
                              tr3.state.model.state_dict().items()):
        assert torch.equal(a, b), k
    for keep in range(4, 8):
        tr3.state.step = keep
        tr3.ckpt.save(tr3.state)
    assert tr3.ckpt.steps() == [5, 6, 7]


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
