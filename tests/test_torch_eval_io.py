"""The eval and artifact side of the last train and eval slice against
the JAX package, on the CPU:

* `eval/lpips.py`: `lpips_distance` on the JAX proxy's own parameters (as
  numpy) against `i2sdf_tpu.eval.lpips.lpips_distance`, at rtol 1e-4 (f32
  convolutions summed in other orders), and `make_lpips` with those
  parameters, its small-image resize included, at the same tolerance; the
  port's own proxy is named `lpips-rf-torch`, never `lpips-rf`;
* `train/artifacts.py`: the colormapped plot, the hot and count maps and
  the point-cloud viewer against the JAX writers (OpenCV's MAGMA through
  `cv2.imwrite`), their PNGs decoded and equal to the pixel;
* `eval/render.py` through the render CLI on the tiny HDR scene's
  held-out views (`--is_val`): `metrics.npz` holds `psnr`, `ssim` and
  `lpips-rf-torch` per view, `metrics.txt` names the LPIPS weights, and
  `--no_fused` renders the same images on the CPU;
* `utils/profiling.py`: a `TraceProfiler` window on the CPU writes a
  Chrome trace that holds its steps and the annotated phases.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.eval import lpips as jlpips
from i2sdf_tpu.train import artifacts as jart
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.eval import lpips as tlpips
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.train import artifacts as tart
from i2sdf_tpu_torch.utils import imaging, profiling
from i2sdf_tpu_torch.utils.colormap import MAGMA
from test_torch_data_io import _io_scene


def _jax_params_as_torch():
    params, name = jlpips.load_params()
    assert name == "lpips-rf"
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


def test_lpips_distance_matches_jax_on_its_parameters():
    jp, tp = _jax_params_as_torch()
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-1, 1, (2, 67, 91, 3)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jlpips.lpips_distance(jp, jnp.asarray(a),
                                            jnp.asarray(b)))
    got = tlpips.lpips_distance(tp, torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert (got > 0).all()
    same = tlpips.lpips_distance(tp, torch.from_numpy(a),
                                 torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-7)


@pytest.mark.parametrize("hw", [(24, 32), (48, 70)], ids=["resized", "as_is"])
def test_make_lpips_matches_jax(monkeypatch, hw):
    jp, tp = _jax_params_as_torch()
    monkeypatch.setattr(tlpips, "load_params", lambda: (tp, "lpips-rf"))
    rng = np.random.default_rng(1)
    pred, gt = (rng.uniform(0, 1, (*hw, 3)).astype(np.float32)
                for _ in range(2))
    got = tlpips.make_lpips()(pred, gt)
    want = jlpips.make_lpips()(pred, gt)
    assert got == pytest.approx(want, rel=1e-4)


def test_port_proxy_has_its_own_name():
    fn = tlpips.make_lpips()
    assert not os.path.exists(tlpips.WEIGHTS_PATH)
    assert fn.name == "lpips-rf-torch" != "lpips-rf"
    img = np.random.default_rng(2).uniform(size=(40, 40, 3))
    assert fn(img, img) == pytest.approx(0.0, abs=1e-7)
    assert fn(img, img[::-1]) > 0
    p0, p1 = tlpips.random_params(), tlpips.random_params()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)   # seeded


def test_magma_table_is_opencv_in_rgb():
    cv2 = pytest.importorskip("cv2")
    bgr = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_MAGMA)[:, 0]
    np.testing.assert_array_equal(MAGMA, bgr[:, ::-1])


def test_hot_and_count_maps_match_jax_pngs(tmp_path):
    rng = np.random.default_rng(3)
    n, res = 3, (10, 14)
    pix = rng.choice(n * 140, 200, replace=False)
    pdf = rng.uniform(0, 1.3, 200).astype(np.float32)
    counts = rng.integers(0, 9, 200)
    lmask = rng.uniform(-0.2, 1.2, res)
    pts = rng.normal(size=(500, 3))
    for mod, d in ((jart, "j"), (tart, "t")):
        (tmp_path / d).mkdir()
        kw = dict(step=7, trace_idx=1, trace_dir=str(tmp_path / d))
        mod.write_hotmaps(str(tmp_path / d / "hot"), pdf, pix, n, res, **kw)
        mod.write_countmaps(str(tmp_path / d / "cnt"), counts, pix, n, res,
                            **kw)
        mod.write_colormap(str(tmp_path / d / "lm.png"), lmask)
        mod.write_pointcloud_html(pts, str(tmp_path / d / "pc.html"), 300)
    names = sorted(str(p.relative_to(tmp_path / "j"))
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(tmp_path / "t"))
                           for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    assert "7_hot.png" in names and "7_cnt.png" in names
    assert "hot/0002.png" in names and "cnt/0000.png" in names
    for name in names:
        a, b = tmp_path / "j" / name, tmp_path / "t" / name
        if name.endswith(".png"):
            ja, tb = imaging.read_png(str(a)), imaging.read_png(str(b))
            assert ja.shape == tb.shape == (*res, 3), name
            np.testing.assert_array_equal(tb, ja, err_msg=name)
        else:
            assert a.read_text() == b.read_text()


def _io_conf(tmp_path):
    """The tiny HDR + mask + val/ scene, its config with `is_hdr`, and a
    seeded model's weights; returns (config path, weights path)."""
    scan = _io_scene(str(tmp_path))
    path = os.path.join(str(tmp_path), "tiny.yml")
    text = open(path).read().replace("dataset:\n",
                                     "dataset:\n    is_hdr: true\n")
    with open(path, "w") as f:
        f.write(text)
    cfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(path).model)
    torch.save(renderer.I2SDFModel(cfg, seed=3).state_dict(),
               tmp_path / "model.pt")
    assert os.path.isdir(os.path.join(scan, "val"))
    return path, str(tmp_path / "model.pt")


def test_render_cli_is_val_writes_metrics_npz(tmp_path, capsys):
    conf, weights = _io_conf(tmp_path)
    base = ["--conf", conf, "--test", "--test_mode", "render", "--is_val",
            "--device", "cpu", "--data_root", str(tmp_path), "--ckpt",
            weights]
    outs = {}
    for name, extra in (("default", []), ("no_fused", ["--no_fused"])):
        exps = str(tmp_path / f"exps_{name}")
        assert tmain.main(base + ["--exps_folder", exps] + extra) == 0
        out = capsys.readouterr().out
        assert ("--no_fused" in out) == (name == "no_fused")
        ev = os.path.join(exps, "quality_0", "version_0", "eval", "test")
        with np.load(os.path.join(ev, "metrics.npz")) as z:
            outs[name] = {k: z[k] for k in z.files}
        lines = open(os.path.join(ev, "metrics.txt")).read().splitlines()
        assert lines[1].startswith("# LPIPS implementation: lpips-rf-torch")
        assert len(lines) == 5 and lines[-1].startswith("[MEAN] [PSNR]")
        pred = imaging.read_png(os.path.join(ev, "rendering",
                                             "0001_pred.png"))
        assert pred.shape == (24, 32, 3)
    got = outs["default"]
    assert set(got) == {"psnr", "ssim", "lpips-rf-torch"}
    assert all(v.shape == (2,) and np.isfinite(v).all()
               for v in got.values())
    for k in got:   # the plain path on the CPU either way
        np.testing.assert_array_equal(outs["no_fused"][k], got[k])


def test_trace_profiler_writes_a_cpu_trace(tmp_path):
    prof = profiling.TraceProfiler.from_spec(str(tmp_path), "1:2")
    assert (prof.start_step, prof.n_steps) == (1, 2)
    assert profiling.TraceProfiler.from_spec(str(tmp_path), "3").n_steps == 5
    assert profiling.TraceProfiler.from_spec(str(tmp_path), None).done
    x = torch.ones(64, 64)
    for step in range(5):
        prof.maybe_start(step)
        with prof.step(step):
            with profiling.annotate("validation"):
                x = torch.tanh(x @ x / 64)
        prof.maybe_stop(step)
    prof.close()
    assert prof.done and prof.path.endswith("trace_1_2.json")
    trace = json.load(open(prof.path))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train/step_1", "train/step_2", "validation"} <= names
    assert "train/step_0" not in names and "train/step_3" not in names
