"""The training step of the background and per-ray configurations
against the JAX package's `make_train_step(fused_sampler=False,
fused_train_grad=False)`: the NeRF++ background on both training
routes, and per-ray sampler compaction at pinned fractions. The tiny
scene, the draws taken from the JAX step's keys and the tolerances are
`test_torch_train_step.py`'s (its module docstring gives their
reasons); the tests sit in a file of their own so that the suite's
workers run them beside that file's, not after them.
"""

import jax
import pytest

from i2sdf_tpu_torch.ops.kernels import conv_check
from test_torch_train_step import (BATCH, PER_RAY_FRACS, _pair,
                                   _step_against_jax)


@pytest.mark.parametrize("normal", [True, False],
                         ids=["render_core", "plain_nets"])
def test_train_step_bg_matches_jax(tmp_path, normal):
    """The step with the NeRF++ background against the JAX step on both
    routes (normal losses on: the render core; off: the plain nets and
    the rev op). The background pair runs on the sampler's inverse-sphere
    depths (their jitter from the JAX sampler's key -1); its leaves are
    among those compared, and move."""
    pair = _pair(tmp_path, False, normal=normal, bg=True)
    jcfg, params, jdata, lcfg, tcfg, model, data = pair
    assert jcfg.use_bg and tcfg.use_bg and tcfg.sampler.inverse_sphere_bg
    assert {"bg_implicit", "bg_rendering"} <= set(params)
    bg0 = {k: p.detach().clone() for k, p in model.named_parameters()
           if k.startswith("bg_")}
    assert len(bg0) == 2 * (4 + 2)
    _step_against_jax(*pair, jax.random.PRNGKey(13))
    for k, p in model.named_parameters():
        if k in bg0:
            assert float((p.detach() - bg0[k]).abs().max()) > 0, k


def test_train_step_per_ray_matches_jax(tmp_path, monkeypatch):
    """The step with per-ray sampler compaction at pinned fractions against
    the JAX step: the later refinement rounds run on half the rays."""
    pair = _pair(tmp_path, False, per_ray=True)
    jcfg, params, jdata, lcfg, tcfg, model, data = pair
    assert jcfg.sampler.per_ray_exit and tcfg.sampler.per_ray_exit
    assert tcfg.sampler.per_ray_fracs == PER_RAY_FRACS
    rows = []
    inner = conv_check.conv_check

    def spy(cfg, z, s, b0):
        rows.append(z.shape[0])
        return inner(cfg, z, s, b0)

    monkeypatch.setattr(conv_check, "conv_check", spy)
    _step_against_jax(*pair, jax.random.PRNGKey(17))
    # 4 checks a step: all rays after round 0 and 1, the capped rows after
    assert rows[:4] == [BATCH, BATCH, BATCH // 2, BATCH // 2], rows
