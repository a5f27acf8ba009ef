"""The training step of the light-mask config with VolSDF's DTU radiance
net (idr mode, `d_in` 9) against the JAX package's
`make_train_step(fused_sampler=False, fused_train_grad=False)`. The tiny
scene (its light masks from `write_light_scene`), the draws taken from
the JAX step's keys and the tolerances are `test_torch_train_step.py`'s
(its module docstring gives their reasons); the config's radiance block
is rewritten to idr here.

The spatial gradient is the idr radiance net's input, so both normal
settings take the render core with the light head beside idr (K3-light-idr
and K4-light-idr on the card, `renderer.py:362-369`), never the rev op;
with `detach_light_feature` off the light loss reaches the SDF net
through relu'(features) too. The normal-off cases are in
`test_torch_train_step_light_idr_nonormal.py`, so that the suite's workers
run the two files side by side.
"""

import jax
import pytest

import test_torch_train_step as tts
from test_torch_train_step_idr import IDR, _count


def check_light_idr_step(tmp_path, monkeypatch, normal, detach):
    """The light-idr step against the JAX step, with the normal losses on
    or off and `detach_light_feature` as given."""
    write = tts.write_light_scene

    def write_idr(root, seed=0):
        path = write(root, seed)
        text = open(path).read()
        assert text.count(IDR[0]) == 1
        with open(path, "w") as f:
            f.write(text.replace(*IDR))
        return path

    monkeypatch.setattr(tts, "write_light_scene", write_idr)
    pair = tts._pair(tmp_path, False, normal=normal, light=True,
                     detach=detach)
    jcfg, params, jdata, lcfg, tcfg, model, data = pair
    assert jcfg.rendering.mode == tcfg.rendering.mode == "idr"
    assert jcfg.use_light and tcfg.use_light and data.light_mask is not None
    assert jcfg.detach_light_feature == tcfg.detach_light_feature == detach
    light0 = {k: p.detach().clone()
              for k, p in model.light.named_parameters()}
    calls = _count(monkeypatch)
    m = tts._step_against_jax(*pair, jax.random.PRNGKey(23))
    assert calls["rev"] == [] and len(calls["core"]) == 3
    assert float(m["light_mask_loss"]) > 0
    assert (float(m["normal_loss"]) > 0) == normal
    assert all(float((p.detach() - light0[k]).abs().max()) > 0
               for k, p in model.light.named_parameters())


@pytest.mark.parametrize("detach", [True, False],
                         ids=["detached", "coupled"])
def test_train_step_light_idr_matches_jax(tmp_path, monkeypatch, detach):
    check_light_idr_step(tmp_path, monkeypatch, True, detach)
