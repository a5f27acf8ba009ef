"""Two results that differed from the JAX package's on the same command,
repaired so that the port copies the JAX behaviour:

* `I2SDFConfig.from_cfgnode` ignores `rendering_network.
  embed_point_multires`, as the JAX one does
  (`i2sdf_tpu/models/renderer.py:78-88`): a config that sets it builds
  the same nets, with the same parameter shapes, in both packages, and
  the port says on one line that it ignored the key;
  `RenderingNetConfig(embed_point_multires=...)` still builds the point
  encoding;
* the seed: `--seed` defaults to 42, and a config's `seed:` wins unless
  `--seed` differs from 42 (`i2sdf_tpu/main.py:63,160`): the JAX CLI's
  rule, run here on its own argument parser beside the port's.
"""

import os

import jax
import numpy as np
import pytest

from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.main import build_argparser as jax_argparser
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.models import mlp, renderer
from i2sdf_tpu_torch.params import from_jax_params
from test_torch_helpers import to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDR = ("mode: nerf\n        d_in: 3",
       "mode: idr\n        d_in: 9\n        embed_point_multires: 6")


def _conf(tmp_path, seed=None):
    text = open(os.path.join(ROOT, "configs", "synthetic_quality.yml")).read()
    assert text.count(IDR[0]) == 1
    text = text.replace(*IDR)
    if seed is not None:
        text = f"seed: {seed}\n" + text
    path = tmp_path / "c.yml"
    path.write_text(text)
    return str(path)


def test_embed_point_multires_in_a_config_builds_the_jax_net(tmp_path,
                                                             capsys):
    path = _conf(tmp_path)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jax_load_cfg(path).model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(path).model)
    assert "embed_point_multires is ignored" in capsys.readouterr().out
    assert tcfg.rendering.embed_point_multires is None
    assert tcfg.rendering.layer_dims() == list(jcfg.rendering.layer_dims())
    assert tcfg.rendering.layer_dims()[0] == 256 + 27 + 6
    params = jrenderer.init(jax.random.PRNGKey(0), jcfg)
    model = renderer.I2SDFModel(tcfg)
    sd = from_jax_params(to_numpy(params), tcfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    # the render core takes the net the config builds, in both packages
    assert renderer.uses_render_core(tcfg)
    # the programmatic config keeps the point encoding
    enc = mlp.RenderingNetConfig(feature_vector_size=256, mode="idr",
                                 d_in=9, dims=(256,),
                                 embed_type="positional", multires=4,
                                 embed_point_multires=6)
    assert enc.layer_dims()[0] == 256 + 27 + 39 + 3


@pytest.mark.parametrize("argv,conf_seed", [
    ([], None), ([], 7), (["--seed", "42"], 7), (["--seed", "5"], 7),
    (["--seed", "5"], None), (["--seed", "42"], None)])
def test_seed_precedence_matches_jax(tmp_path, argv, conf_seed):
    path = _conf(tmp_path, conf_seed)
    jargs = jax_argparser().parse_args(["--conf", path] + argv)
    jconf = jax_load_cfg(path)
    # i2sdf_tpu/main.py:160-161, the JAX CLI's rule on its own parser
    if jargs.seed != 42 or "seed" not in jconf:
        jconf.seed = jargs.seed
    targs = tmain.build_argparser().parse_args(["--conf", path] + argv)
    got = tmain.resolve_seed(targs.seed, load_cfg(path))
    assert targs.seed == jargs.seed
    assert got == jconf.seed
    assert got == (conf_seed if conf_seed is not None and argv[-1:] != ["5"]
                   else int(argv[-1]) if argv else 42)
