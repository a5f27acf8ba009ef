"""The port's material trainer and its consumers
(`i2sdf_tpu_torch/train/material.py`, relight and mesh `--use_material`,
the `--material` CLI) against the JAX package's on the CPU: the
synthetic scene (`generate_synthetic_scene`, 3 images of 20 x 24), the
narrow light-mask model of the relight tests (`light_pair`, its JAX
parameters perturbed off the init), a 2 x 16 material net.

- `MaterialTrainer`'s emitters at atol 1e-4 (the trainer's draws JAX's
  `PRNGKey(seed)`), its baked training buffers and per-image valid flags
  equal in count and flag, the buffers at atol 1e-5 at all but 1 % of the
  samples and all within 0.05 (the eval render's tolerance where the two
  samplers' float decisions part, `test_torch_material.py`); with
  `indirect_spp` the smoothed bounce buffer at atol 1e-4;
- `fit` to 6 then a new trainer's `resume` to 8 equal to a straight fit
  to 8, bit for bit (parameters and Adam state);
- (`test_torch_material_use.py`: the trained stage in relight and mesh
  against the JAX package's;)
- `python -m i2sdf_tpu_torch.main --material` (and `--resume`), then
  relight, relight_video and mesh `--use_material`, with `--device
  cpu`."""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import CfgNode as JNode
from i2sdf_tpu.data import generate_synthetic_scene
from i2sdf_tpu.train import material as jtm
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import CfgNode as TNode
from i2sdf_tpu_torch.train import material as ttm
from i2sdf_tpu_torch.utils import exr
from test_torch_helpers import JaxDraws
from test_torch_relight_cli import CONF, _yaml, light_pair

MATERIAL = {"steps": 8, "batch_size": 64, "spp": 2, "vis_steps": 4,
            "n_emitters": 1, "plot_freq": 5, "checkpoint_freq": 5,
            "min_weight_sum": 0.05,
            "material_network": {"dims": [16, 16], "multires": 2}}
MCONF = {**CONF, "material": MATERIAL,
         "plot": {"grid_boundary": [-2.2, 2.2]}}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("material_trainer")
    generate_synthetic_scene(str(root / "demo"), n_images=3,
                             img_res=(20, 24))
    return str(root)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return light_pair(str(tmp_path_factory.mktemp("pair")))


def _conf(**material):
    d = copy.deepcopy(MCONF)
    d["material"].update(material)
    return d


def _close_buffers(got, want):
    assert got.shape == want.shape
    gap = np.abs(got - want).reshape(len(got), -1).max(-1)
    assert (gap > 1e-5).sum() <= 0.01 * len(got) and gap.max() < 0.05


@pytest.mark.parametrize("indirect_spp", [0, 2])
def test_trainer_emitters_and_bake_match_jax(scene, pair, tmp_path,
                                             indirect_spp):
    jcfg, params, model, _ = pair
    d = _conf(indirect_spp=indirect_spp, indirect_steps=8,
              indirect_chunk=512)
    jmt = jtm.MaterialTrainer(JNode(d), str(tmp_path / "jax"),
                              recon_params=params, model_cfg=jcfg,
                              data_root=scene, fused=False, seed=3)
    tmt = ttm.MaterialTrainer(TNode(d), str(tmp_path / "port"), model,
                              data_root=scene, fused=False, seed=3,
                              draws=JaxDraws(jax.random.PRNGKey(3)))
    for a in ("centers", "radii", "radiance"):
        np.testing.assert_allclose(getattr(tmt.emitters, a).numpy(),
                                   np.asarray(getattr(jmt.emitters, a)),
                                   atol=1e-4)
    assert set(tmt.buffers) == set(jmt.buffers)
    for k in ("points", "normals", "view_dirs", "rgb"):
        _close_buffers(tmt.buffers[k].numpy(), np.asarray(jmt.buffers[k]))
    for g, w in zip(tmt.per_image, jmt.per_image):
        np.testing.assert_array_equal(g["valid"], np.asarray(w["valid"]))
    if indirect_spp:
        np.testing.assert_allclose(tmt.buffers["e_ind"].numpy(),
                                   np.asarray(jmt.buffers["e_ind"]),
                                   atol=1e-4)
        assert float(tmt.buffers["e_ind"].max()) > 0
    em = np.load(tmp_path / "port" / "material" / "emitters.npz")
    np.testing.assert_array_equal(em["init_radiance"],
                                  tmt.emitters.radiance.numpy())


@pytest.fixture(scope="module")
def trained(scene, pair, tmp_path_factory):
    """A straight fit to 8, and a fit to 6 resumed by a new trainer to 8."""
    _, _, model, _ = pair
    root = tmp_path_factory.mktemp("fit")
    out = {}
    for name in ("straight", "resumed"):
        exp = str(root / name)
        mt = ttm.MaterialTrainer(TNode(MCONF), exp, model, data_root=scene,
                                 fused=False, seed=0)
        if name == "resumed":
            mt.fit(max_steps=6)
            mt = ttm.MaterialTrainer(TNode(MCONF), exp, model,
                                     data_root=scene, fused=False, seed=0)
            assert mt.resume() == 6
        out[name] = (mt.fit(max_steps=8), exp, mt)
    return out


def test_fit_then_resume_equals_a_straight_fit(trained):
    (a, exp_a, mt), (b, exp_b, _) = trained["straight"], trained["resumed"]
    assert a.step == b.step == 8
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert mt.ckpt.steps() == [5, 8]
    plots = sorted(os.listdir(os.path.join(exp_a, "material", "plots")))
    assert plots == ["kd_000005_0.png", "render_000005_0.png",
                     "rough_000005_0.png"]
    emission = torch.exp(a.model.emission["log_radiance"])
    assert torch.isfinite(emission).all() and bool((emission > 0).all())


def _ply_colors(path):
    """(verts, uchar colours) of a binary PLY with vertex colours."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    head = data[:end].decode()
    assert "property uchar red" in head
    n = int(head.split("element vertex ")[1].split()[0])
    rec = np.frombuffer(data, [("p", "<f4", (3,)), ("c", "u1", (3,))], n,
                        end)
    return rec["p"], rec["c"].astype(int)


def test_material_cli(scene, pair, tmp_path, capsys):
    """`--material` for 2 steps, `--resume` to 3, then relight,
    relight_video and mesh with `--use_material`, through `main` with
    `--device cpu`."""
    _, _, model, _ = pair
    pt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), pt)
    conf = tmp_path / "material.yml"
    conf.write_text(_yaml(MCONF) + "\n")
    base = ["--conf", str(conf), "--device", "cpu", "--ckpt", pt,
            "--data_root", scene, "--exps_folder", str(tmp_path / "exps")]
    assert tmain.main(base + ["--material", "--max_steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "[material 2/2]" in out and "[material] baked view 2" in out
    assert tmain.main(base + ["--material", "--resume", "--max_steps",
                              "3"]) == 0
    out = capsys.readouterr().out
    assert "[material] resumed from step 2" in out and "[material 3/3]" in out
    exp = tmp_path / "exps" / "relight_0" / "version_0"
    assert sorted(os.listdir(exp / "material" / "checkpoints")) == [
        "step_2.pt", "step_3.pt"]
    test = base + ["--test", "--use_material", "--spp", "2"]
    assert tmain.main(test + ["--test_mode", "relight", "--indices",
                              "0"]) == 0
    out = capsys.readouterr().out
    assert "[material] restored material stage @3" in out
    assert "using trained material stage" in out
    img, _ = exr.read_exr(str(exp / "eval" / "relight" / "0000_relit.exr"))
    assert img.shape == (20, 24, 3) and np.isfinite(img).all()
    assert (img >= 0).all()
    assert tmain.main(test + ["--test_mode", "relight_video", "--inter_id",
                              "0", "1", "--n_frames", "2"]) == 0
    assert "using trained material stage" in capsys.readouterr().out
    assert sorted(os.listdir(exp / "eval" / "relight_video" / "0000_0001")
                  ) == ["0000.png", "0001.png"]
    assert tmain.main(test + ["--test_mode", "mesh", "--resolution",
                              "24"]) == 0
    assert "baked learned albedo" in capsys.readouterr().out
    _ply_colors(str(exp / "eval" / "mesh" / "scan0.ply"))
