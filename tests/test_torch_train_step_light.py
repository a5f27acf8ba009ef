"""The light-mask config's training step against the JAX package's
`make_train_step(fused_sampler=False, fused_train_grad=False)`, on its
two routes and both `detach_light_feature` values. The tiny scene (its
light masks from `write_light_scene`), the draws taken from the JAX
step's keys and the tolerances are `test_torch_train_step.py`'s (its
module docstring gives their reasons); the four cases sit in a file of
their own so that the suite's workers run them beside that file's, not
after them.
"""

import jax
import pytest

from test_torch_train_step import _pair, _step_against_jax


@pytest.mark.parametrize("detach", [True, False],
                         ids=["detached", "coupled"])
@pytest.mark.parametrize("normal", [True, False],
                         ids=["render_core", "plain_light_net"])
def test_train_step_light_matches_jax(tmp_path, normal, detach):
    """The light-mask config's step against the JAX step on its two
    routes: normal losses on (the render core with the light head; K3/K4
    with it on the card) and off (the plain light net on the render
    points' relu(features), `renderer.py:456-462`), with
    `detach_light_feature` on (the light loss reaches the light net only)
    and off (it reaches the SDF net through relu'(features)). Loss terms,
    the light term among them, gradients and the parameters after 3
    steps, the light net's and the SDF net's included, at the module
    docstring's tolerances."""
    pair = _pair(tmp_path, False, normal=normal, light=True, detach=detach)
    jcfg, params, jdata, lcfg, tcfg, model, data = pair
    assert jcfg.use_light and tcfg.use_light and data.light_mask is not None
    assert jcfg.detach_light_feature == tcfg.detach_light_feature == detach
    assert lcfg.light_mask_weight == 0.5
    light0 = {k: p.detach().clone()
              for k, p in model.light.named_parameters()}
    metrics = _step_against_jax(*pair, jax.random.PRNGKey(5))
    assert float(metrics["light_mask_loss"]) > 0
    assert all(float((p.detach() - light0[k]).abs().max()) > 0
               for k, p in model.light.named_parameters())
