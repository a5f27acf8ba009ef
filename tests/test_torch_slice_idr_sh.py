"""The eval render and the CLIs with the idr-mode radiance net (VolSDF's
DTU radiance net, `d_in` 9) and with the spherical-harmonics view
encoding, on the CPU.

* `render_rays` against the JAX package's `render_rays(training=False,
  fused_sampler=False)` on the same converted parameters and rays, with
  `test_torch_slice.py`'s narrow nets and tolerances (rgb 1e-4, depth
  and normal 1e-3, both f32): idr takes the render core's route (K3-idr
  on the card), SH the rev op's (K5 on the chunk's points,
  `renderer.py:337-343`), the radiance net plain;
* the train CLI for one step and the render CLI on its checkpoint, on
  the tiny scene of `test_torch_train_step.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.data.plot import PlotData
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.ops.kernels import render_core, rev
from i2sdf_tpu_torch.params import from_jax_params
from i2sdf_tpu_torch.utils import imaging
from test_torch_helpers import to_numpy
from test_torch_slice import CONF, DATA, _narrow
from test_torch_train_step import write_tiny_scene

EDITS = {"idr": ("mode: nerf\n        d_in: 3", "mode: idr\n        d_in: 9"),
         "sh": ("embed_type: 'positional'\n        multires: 4",
                "embed_type: spherical_harmonics\n        multires: 4")}


def _edited(src, dst, kind):
    text = open(src).read()
    assert text.count(EDITS[kind][0]) == 1
    dst.write_text(text.replace(*EDITS[kind]))
    return str(dst)


@pytest.mark.parametrize("kind", list(EDITS))
def test_eval_render_matches_jax(tmp_path, monkeypatch, kind):
    path = _edited(CONF, tmp_path / "c.yml", kind)
    jc, tc = _narrow(jax_load_cfg(path)), _narrow(load_cfg(path))
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jc.model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(tc.model)
    params = jrenderer.init(jax.random.PRNGKey(0), jcfg)
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(to_numpy(params), tcfg))
    assert renderer.uses_render_core(tcfg) == (kind == "idr")
    pd = PlotData("synthetic_quality", scan_id=1, data_root=DATA,
                  downsample=2, indices=[0])
    uv, K, pose, _ = pd.image_inputs(0)
    sel = np.random.default_rng(1).choice(len(uv), 64, replace=False)
    inputs = {"uv": uv[sel][None], "intrinsics": K[None], "pose": pose[None]}
    ref = jax.jit(lambda p, i: jrenderer.render_rays(
        p, jcfg, i, jax.random.PRNGKey(0), training=False,
        fused_sampler=False))(params, {k: jnp.asarray(v)
                                       for k, v in inputs.items()})
    routes = []
    monkeypatch.setattr(render_core, "render_core_plain",
                        lambda *a, f=render_core.render_core_plain, **k:
                        routes.append("core") or f(*a, **k))
    monkeypatch.setattr(rev, "sdf_outputs_rev_eval",
                        lambda *a, f=rev.sdf_outputs_rev_eval, **k:
                        routes.append("rev") or f(*a, **k))
    got = renderer.render_rays(model, {k: torch.from_numpy(v)
                                       for k, v in inputs.items()})
    assert routes == ["core" if kind == "idr" else "rev"]
    for key, tol in (("rgb_values", 1e-4), ("depth_values", 1e-3),
                     ("normal_map", 1e-3), ("weight_sum", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("kind", list(EDITS))
def test_train_and_render_cli(tmp_path, kind):
    conf = _edited(write_tiny_scene(str(tmp_path)), tmp_path / "k.yml", kind)
    args = ["--conf", conf, "--device", "cpu", "--data_root", str(tmp_path),
            "--exps_folder", str(tmp_path / "exps"), "--log_every", "1"]
    assert tmain.main(args + ["--max_steps", "1"]) == 0
    assert tmain.main(args + ["--test", "--test_mode", "render",
                              "--indices", "0"]) == 0
    exps = tmp_path / "exps"
    (ev,) = exps.glob("*/version_0/eval")
    pred = imaging.read_png(str(ev / "rendering" / "0000_pred.png"))
    assert pred.shape == (24, 32, 3)
    normal = np.load(ev / "normal" / "0000.npy")
    assert np.isfinite(normal).all()
