"""Parameters and checkpoints of this slice's configurations: the
converter carries the NeRF++ background's nets (JAX leaves `{"w", "b"}`
with weight norm off), and a checkpoint with `--resume`'s restore carries
the background nets, their Adam moments and the per-ray phase (which the
resumed trainer takes again from the restored beta).

Kept apart from `test_torch_train_io.py`, whose CLI and trainer tests are
the suite's longest file. The trainers here skip the validation render,
which is not under test (`test_torch_train_io.py` drives it)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.params import from_jax_params, to_jax_params
from i2sdf_tpu_torch.train.checkpoint import CheckpointManager
from i2sdf_tpu_torch.train.trainer import ReconstructionTrainer
from test_torch_train_step import BG_BLOCK, write_tiny_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the slice's background block, at the widths of VolSDF's BlendedMVS config
FULL_BG = """    bg_network:
        feature_vector_size: 256
        implicit_network:
            d_in: 4
            d_out: 1
            dims: [256, 256, 256, 256, 256, 256, 256, 256]
            geometric_init: False
            skip_in: [4]
            weight_norm: False
            embed_type: positional
            multires: 10
        rendering_network:
            mode: nerf
            d_in: 3
            d_out: 3
            dims: [128]
            weight_norm: False
            embed_type: positional
            multires: 4

"""


def test_params_convert_with_background_nets(tmp_path):
    """`from_jax_params` / `to_jax_params` carry the background's nets at
    full width: the JAX package's init into the port's model and back,
    leaf for leaf."""
    text = open(os.path.join(ROOT, "configs", "synthetic_quality.yml")).read()
    path = str(tmp_path / "bg.yml")
    with open(path, "w") as f:
        f.write(text.replace("    density:\n", FULL_BG + "    density:\n"))
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jax_load_cfg(path).model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(path).model)
    assert tcfg.bg_implicit.layer_dims() == jcfg.bg_implicit.layer_dims()
    assert tcfg.bg_implicit.layer_dims()[0] == 84
    assert tcfg.bg_rendering.layer_dims() == [283, 128, 3]
    tree = jax.tree_util.tree_map(np.asarray,
                                  jrenderer.init(jax.random.PRNGKey(0), jcfg))
    assert set(tree["bg_implicit"]["lin0"]) == {"w", "b"}
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(tree, tcfg))
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "implicit", "rendering", "bg_implicit", "bg_rendering", "beta"}
    back = to_jax_params(model.state_dict())
    assert set(back) == set(tree)
    for net in ("bg_implicit", "bg_rendering"):
        assert set(back[net]) == set(tree[net])
        for lin, leaves in tree[net].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(back[net][lin][leaf], v)
    with pytest.raises(KeyError):
        from_jax_params({k: v for k, v in tree.items() if k != "bg_rendering"},
                        tcfg)


def _bg_trainer(root, exp="exp"):
    """A trainer on the tiny scene with the background block and per-ray
    compaction on the beta ladder, its validation render skipped."""
    path = write_tiny_scene(str(root))
    text = open(path).read().replace("    density:\n",
                                     BG_BLOCK + "    density:\n")
    with open(path, "w") as f:
        f.write(text)
    conf = load_cfg(path)
    conf.model.ray_sampler.per_ray_exit = True
    conf.loss.min_bubble_iter = 1000
    tr = ReconstructionTrainer(conf, str(root / exp), data_root=str(root),
                               device="cpu", seed=3)
    tr.validate = lambda step: None
    return tr


def test_bg_checkpoint_and_resume_carry_nets_and_phase(tmp_path):
    """The background nets and their Adam moments go into the checkpoint;
    a run resumed from it (with beta 0.03 restored, so in the compacted
    phase from its first step) ends where an uninterrupted one does."""
    tr = _bg_trainer(tmp_path / "a")
    with torch.no_grad():
        tr.state.model.beta.fill_(0.03)
    tr.fit(max_steps=2, log_every=10)
    assert tr.per_ray_fracs == (1.0, 1.0, 1.0, 0.77)
    ckpt = CheckpointManager(str(tmp_path / "a" / "exp" / "checkpoints"))
    payload = torch.load(ckpt.path(2), weights_only=True)
    assert {k.split(".")[0] for k in payload["model"]} >= {"bg_implicit",
                                                           "bg_rendering"}
    assert len(payload["optimizer"]["state"]) == len(
        list(tr.state.model.parameters()))
    shutil.copytree(ckpt.ckpt_dir, tmp_path / "saved")
    tr3 = _bg_trainer(tmp_path / "c")
    assert tr3.per_ray_fracs is None   # beta 0.1 before the restore
    tr3.ckpt = CheckpointManager(str(tmp_path / "saved"))
    tr3.fit(max_steps=3, resume=True, log_every=10)
    assert tr3.per_ray_fracs == (1.0, 1.0, 1.0, 0.77)
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
