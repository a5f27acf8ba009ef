"""The port's relight entry points and CLI (`i2sdf_tpu_torch/eval/relight.py`,
`--test_mode relight|relight_video`) against the JAX package's on the
CPU: the synthetic scene (`i2sdf_tpu.data.generate_synthetic_scene`, 3
images of 20 x 24), a narrow light-mask model whose JAX parameters
(perturbed off the init) cross with `params.py`, the draws JAX's own
(`JaxDraws` from the JAX keys `PRNGKey(seed)` and, for the clustering,
`PRNGKey(0)`). The relit, diffuse and specular images within PSNR 40 dB of
the JAX package's (the PNGs and the linear relit image, `.exr` in both),
the emitters at atol 1e-4; then one CLI run of each mode with `--device
cpu`, the GT emitters and, on a copy of the scene without depth, the
model-head fallback; `--use_material` before a material stage exists
fails, `--material` trains one (zero steps: its bake, calibration and
checkpoint) and `--use_material` then relights with it."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import CfgNode as JNode
from i2sdf_tpu.data import generate_synthetic_scene
from i2sdf_tpu.eval import relight as jrel
from i2sdf_tpu.models import renderer as jren
from i2sdf_tpu.utils import imaging as jimaging
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import CfgNode as TNode
from i2sdf_tpu_torch.eval import relight as trel
from i2sdf_tpu_torch.models import renderer as tren
from i2sdf_tpu_torch.params import from_jax_params
from i2sdf_tpu_torch.utils import exr, imaging
from test_torch_helpers import JaxDraws, perturbed

PSNR_BAR_DB = 40.0
# the 3 views see no light-mask pixel, so the emitter is the brightest
# pixels' cluster on the far wall: a small, far sphere, scaled up so its
# light shows in 8-bit images
EMITTER_SCALE = 200.0
LIGHT_MODEL = {
    "feature_vector_size": 16,
    "scene_bounding_sphere": 4.0,
    "implicit_network": {
        "d_in": 3, "d_out": 1, "dims": [32, 32, 32, 32],
        "geometric_init": True, "bias": 0.6, "skip_in": [2],
        "weight_norm": True, "embed_type": "positional", "multires": 4},
    "rendering_network": {
        "mode": "nerf", "d_in": 3, "d_out": 3, "dims": [32, 32],
        "weight_norm": True, "embed_type": "positional", "multires": 2},
    "light_network": {"dims": [16]},
    "density": {"params_init": {"beta": 0.1}, "beta_min": 1e-4},
    "ray_sampler": {"near": 0.0, "N_samples": 12, "N_samples_eval": 24,
                    "N_samples_extra": 6, "eps": 0.1, "beta_iters": 4,
                    "max_total_iters": 2},
}
CONF = {"train": {"expname": "relight", "split_n_pixels": 512},
        "dataset": {"data_dir": "demo", "img_res": [20, 24],
                    "downsample": 1, "scan_id": 0},
        "model": LIGHT_MODEL}


def _yaml(d, indent=0):
    """The config subset of YAML the port's reader takes."""
    out = []
    for k, v in d.items():
        if isinstance(v, dict):
            out += [" " * indent + f"{k}:", _yaml(v, indent + 4)]
        else:
            out.append(" " * indent + f"{k}: {v}")
    return "\n".join(out)


def light_pair(root):
    """(JAX config, JAX parameters perturbed off the init, the port's model
    with the same weights, the port's config path, written to `root`)."""
    jn = JNode(CONF)
    jn.model.use_normal = False
    jcfg = jren.I2SDFConfig.from_cfgnode(jn.model)
    params = jax.tree_util.tree_map(jax.numpy.asarray, perturbed(
        jren.init(jax.random.PRNGKey(0), jcfg), 2))
    tcfg = tren.I2SDFConfig.from_cfgnode(TNode(CONF).model)
    model = tren.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    path = os.path.join(root, "relight.yml")
    with open(path, "w") as f:
        f.write(_yaml(CONF) + "\n")
    return jcfg, params, model, path


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("relight_cli")
    generate_synthetic_scene(str(root / "demo"), n_images=3,
                             img_res=(20, 24))
    return str(root)


def _psnr_u8(a_path, b_path):
    a = imaging.read_png(a_path).astype(np.float32) / 255
    b = imaging.read_png(b_path).astype(np.float32) / 255
    assert a.shape == b.shape == (20, 24, 3)
    return imaging.psnr(a, b)


def _linear_psnr(got, want):
    peak = max(float(np.abs(want).max()), 1e-6)
    return imaging.psnr(got / peak, want / peak)


@pytest.mark.parametrize("indirect_spp,edit", [(0, False), (2, True)])
def test_run_relight_matches_jax(scene, tmp_path, indirect_spp, edit):
    """Views 0 and 2; with the bounce, an edit config too (an
    `emission_scale` and a kd map at another size, blended by a mask)."""
    jcfg, params, model, _ = light_pair(str(tmp_path))
    edit_conf = None
    if edit:
        rng = np.random.default_rng(3)
        kd = str(tmp_path / "kd.png")
        mask = str(tmp_path / "mask.png")
        imaging.write_png(kd, rng.integers(0, 256, (30, 31, 3),
                                           dtype=np.uint8))
        imaging.write_png(mask, np.tile(np.arange(24, dtype=np.uint8) * 10,
                                        (20, 1)))
        edit_conf = {"emission_scale": [2.0, 1.0, 0.5], "kd": kd,
                     "mask": mask}
    kw = dict(data_root=scene, indices=[0, 2], spp=4, n_emitters=1,
              chunk=256, vis_steps=8, seed=5, indirect_spp=indirect_spp,
              edit_conf=edit_conf, emitter_scale=EMITTER_SCALE)
    jn = JNode(CONF)
    jres = jrel.run_relight(params, jcfg, jn, str(tmp_path / "jax"),
                            fused=False, **kw)
    tres = trel.run_relight(model, TNode(CONF), str(tmp_path / "port"),
                            fused=False, draws=JaxDraws(
                                jax.random.PRNGKey(5)),
                            emitter_draws=JaxDraws(jax.random.PRNGKey(0)),
                            **kw)
    assert tres["emitters"] == jres["emitters"] == 1
    jdir = str(tmp_path / "jax" / "eval" / "relight")
    tdir = str(tmp_path / "port" / "eval" / "relight")
    assert sorted(os.listdir(tdir)) == sorted(
        f"{t}_{n}" for t in ("0000", "0002")
        for n in ("relit.png", "diffuse.png", "specular.png", "relit.exr"))
    for tag in ("0000", "0002"):
        for name in ("relit", "diffuse", "specular"):
            assert _psnr_u8(os.path.join(tdir, f"{tag}_{name}.png"),
                            os.path.join(jdir, f"{tag}_{name}.png")
                            ) >= PSNR_BAR_DB, (tag, name)
        want = [f for f in os.listdir(jdir) if f.startswith(f"{tag}_relit.")
                and not f.endswith(".png")]
        want = jimaging.load_rgb(os.path.join(jdir, want[0]), is_hdr=True)
        got, _ = exr.read_exr(os.path.join(tdir, f"{tag}_relit.exr"))
        assert got.shape == (20, 24, 3) and np.isfinite(got).all()
        assert _linear_psnr(got, np.asarray(want)) >= PSNR_BAR_DB
    means = [r["mean_radiance"] for r in tres["images"]]
    np.testing.assert_allclose(means, [r["mean_radiance"]
                                       for r in jres["images"]], rtol=1e-3)
    assert max(means) > 0.01
    # the emitters both contexts found
    jctx = jrel._RelightContext(params, jcfg, jn, scene, 1, EMITTER_SCALE,
                                4, 8, False, None, edit_conf=edit_conf)
    tctx = trel.RelightContext(model, TNode(CONF), scene, 1, EMITTER_SCALE,
                               4, 8, fused=False, edit_conf=edit_conf,
                               emitter_draws=JaxDraws(jax.random.PRNGKey(0)))
    for a in ("centers", "radii", "radiance"):
        np.testing.assert_allclose(getattr(tctx.emitters, a).numpy(),
                                   np.asarray(getattr(jctx.emitters, a)),
                                   atol=1e-4)


def test_run_relight_video_matches_jax(scene, tmp_path):
    jcfg, params, model, _ = light_pair(str(tmp_path))
    kw = dict(data_root=scene, id0=0, id1=2, n_frames=2, spp=2,
              n_emitters=1, chunk=256, vis_steps=4, seed=1,
              emitter_scale=EMITTER_SCALE)
    jres = jrel.run_relight_video(params, jcfg, JNode(CONF),
                                  str(tmp_path / "jax"), fused=False, **kw)
    tres = trel.run_relight_video(
        model, TNode(CONF), str(tmp_path / "port"), fused=False,
        draws=JaxDraws(jax.random.PRNGKey(1)),
        emitter_draws=JaxDraws(jax.random.PRNGKey(0)), **kw)
    assert tres["frames"] == jres["frames"] == 2
    assert (tres["mp4"] is None) == (shutil.which("ffmpeg") is None)
    for i in range(2):
        assert _psnr_u8(os.path.join(tres["frame_dir"], f"{i:04d}.png"),
                        os.path.join(jres["frame_dir"], f"{i:04d}.png")
                        ) >= PSNR_BAR_DB
    np.testing.assert_allclose(tres["mean_radiance"], jres["mean_radiance"],
                               rtol=1e-3)


def test_relight_cli_both_modes_and_the_refusals(scene, tmp_path, capsys):
    """`--test_mode relight` on the scene (GT masks and depth; here the
    brightest-pixels selection), again on a copy without depth (the
    model-head fallback), `relight_video`; `--use_material` fails while
    the experiment has no material stage, `--material --max_steps 0`
    writes one, and `--use_material` then relights with it (these were
    refusals until the material stage was ported)."""
    _, _, model, conf = light_pair(str(tmp_path))
    pt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), pt)
    nodepth = tmp_path / "nodepth"
    shutil.copytree(os.path.join(scene, "demo"), nodepth / "demo")
    shutil.rmtree(nodepth / "demo" / "scan0" / "depth")
    base = ["--conf", conf, "--device", "cpu", "--ckpt", pt, "--test",
            "--spp", "2", "--emitter_scale", str(EMITTER_SCALE),
            "--exps_folder", str(tmp_path / "exps")]
    for root, extra in ((scene, ["--test_mode", "relight", "--indices", "1",
                                 "--indirect_spp", "1"]),
                        (str(nodepth), ["--test_mode", "relight", "--indices",
                                        "0", "--version", "1"]),
                        (scene, ["--test_mode", "relight_video",
                                 "--inter_id", "0", "1", "--n_frames", "2",
                                 "--version", "0"])):
        assert tmain.main(base + ["--data_root", root] + extra) == 0
        out = capsys.readouterr().out
        assert "[relight] 1 emitters; centers=" in out
        assert ("falling back to the model's light head" in out) == (
            root != scene), out
    exp = tmp_path / "exps" / "relight_0"
    relit = sorted(os.listdir(exp / "version_0" / "eval" / "relight"))
    assert relit == ["0001_diffuse.png", "0001_relit.exr", "0001_relit.png",
                     "0001_specular.png"]
    assert "0000_relit.png" in os.listdir(exp / "version_1" / "eval"
                                          / "relight")
    img, _ = exr.read_exr(str(exp / "version_0" / "eval" / "relight"
                              / "0001_relit.exr"))
    assert img.shape == (20, 24, 3) and np.isfinite(img).all()
    assert (img >= 0).all()
    frames = exp / "version_0" / "eval" / "relight_video" / "0000_0001"
    assert sorted(os.listdir(frames)) == ["0000.png", "0001.png"]
    use = base + ["--data_root", scene, "--test_mode", "relight", "--indices",
                  "0", "--version", "0", "--use_material"]
    with pytest.raises(FileNotFoundError, match="run --material first"):
        tmain.main(use)
    assert tmain.main(base + ["--data_root", scene, "--version", "0",
                              "--material", "--max_steps", "0"]) == 0
    assert os.path.isfile(exp / "version_0" / "material" / "emitters.npz")
    assert tmain.main(use) == 0
    assert "using trained material stage" in capsys.readouterr().out
