"""The training step's normal-loss-off route and its bubble window
against the JAX package's `make_train_step(fused_sampler=False,
fused_train_grad=False)`. The tiny scene, the draws taken from the JAX
step's keys and the tolerances are `test_torch_train_step.py`'s (its
module docstring gives their reasons); the two tests sit in a file of
their own so that the suite's workers run them beside that file's, not
after them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.data.recon import sample_batch as jax_sample_batch
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu.models.losses import compute_losses as jax_losses
from i2sdf_tpu.train.state import create_train_state as jax_train_state
from i2sdf_tpu.train.step import make_train_step as jax_make_step
from i2sdf_tpu_torch.ops.kernels import render_core, rev
from i2sdf_tpu_torch.train import step as tstep
from i2sdf_tpu_torch.train.state import create_train_state
from test_torch_train_step import BATCH, LR, _flat_params, _pair, jax_draws


def test_train_step_normal_off_matches_jax(tmp_path, monkeypatch):
    """With the normal losses off, the JAX step renders the points with no
    spatial gradient and takes `grad_theta` from the eikonal points alone
    (`renderer.py:387-394,473-477`); the port takes the same route, with
    the rev op (K5/K6 on the card) and never the render core."""
    jcfg, params, jdata, lcfg, tcfg, model, data = _pair(tmp_path, False,
                                                         normal=False)
    assert not tcfg.use_normal and data.normal is None
    base = jax.random.PRNGKey(11)
    weights = lcfg.dynamic_weights(0)
    assert weights["normal"] == 0 and weights["angular"] == 0
    jw = {k: jnp.float32(v) for k, v in weights.items()}

    def jloss(p):
        key = jax.random.fold_in(base, 0)
        k_batch, _, k_render = jax.random.split(key, 3)
        _, inputs, gt = jax_sample_batch(jdata, k_batch, BATCH)
        out = jrenderer.render_rays(p, jcfg, inputs, k_render, training=True,
                                    fused_sampler=False,
                                    fused_train_grad=False)
        terms = jax_losses(out, gt, jw)
        return terms["loss"], terms

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    def no_render_core(*a, **k):
        raise AssertionError("the render core ran with the normal loss off")

    calls = []

    def counted(net, x, plain=False):
        calls.append(x.shape[0])
        return sdf_outputs_rev(net, x, plain=plain)

    sdf_outputs_rev = rev.sdf_outputs_rev
    monkeypatch.setattr(render_core, "render_core_train", no_render_core)
    monkeypatch.setattr(rev, "sdf_outputs_rev", counted)
    state = create_train_state(model, learning_rate=LR, decay_steps=200_000)
    step = tstep.make_train_step(tcfg, BATCH)
    metrics = step(state, data, jax_draws(jcfg, jdata, base, 0), weights)
    assert calls == [3 * BATCH]
    assert float(metrics["normal_loss"]) == 0.0
    assert float(metrics["angular_loss"]) == 0.0
    for k, v in jterms.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=2e-5,
                                                  abs=1e-7), k
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    for k, ref in _flat_params(jgrads).items():
        scale = max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=5e-4 * scale,
                                   err_msg=k)


def test_bubble_step_matches_jax(tmp_path):
    """Inside the bubble window: the same bubble points, loss terms,
    updated pdf and sample counts. The JAX package's pdf scatter sends
    pixels without a point (pointlinks -1) to the last point
    (`.at[-1].set(mode="drop")` wraps a negative index); the port drops
    them, so the pdfs agree everywhere but there."""
    jcfg, params, jdata, lcfg, tcfg, model, data = _pair(tmp_path, True)
    base = jax.random.PRNGKey(3)
    weights = lcfg.dynamic_weights(0)
    assert weights["bubble"] > 0 and weights["normal"] == 0
    jw = {k: jnp.float32(v) for k, v in weights.items()}
    P = jdata.pointcloud.shape[0]
    pdf0 = jnp.asarray(np.random.default_rng(1).uniform(size=P), jnp.float32)
    jstate, tx = jax_train_state(params, learning_rate=LR,
                                 decay_steps=200_000)
    jstep = jax_make_step(jcfg, tx, BATCH, bubble=True, pdf_prune=0.05,
                          pdf_max=0.2, fused_sampler=False,
                          fused_train_grad=False, donate=False)
    _, jm, jpdf, jcount = jstep(jstate, jdata, base, jw, pdf0,
                                jnp.zeros((P,), jnp.int32))
    state = create_train_state(model, learning_rate=LR, decay_steps=200_000)
    step = tstep.make_train_step(tcfg, BATCH, pdf_prune=0.05, pdf_max=0.2)
    draws = jax_draws(jcfg, jdata, base, 0, pdf=pdf0)
    bub = tstep.BubbleState(pdf=torch.from_numpy(np.array(pdf0)),
                            sample_count=torch.zeros(P, dtype=torch.int64))
    m = step(state, data, draws, weights, bub)
    for k in ("loss", "bubble_loss", "rgb_loss", "depth_loss"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=2e-5), k
    np.testing.assert_array_equal(bub.sample_count.numpy(),
                                  np.asarray(jcount))
    np.testing.assert_allclose(bub.pdf.numpy()[:-1], np.asarray(jpdf)[:-1],
                               rtol=1e-3, atol=1e-5)
    assert (data.pointlinks < 0).any()
