"""The training step with the idr-mode radiance net (VolSDF's DTU
radiance net at narrow widths: [points | PE(view) | normals | features],
`d_in` 9) and with the spherical-harmonics view encoding, against the
JAX package's `make_train_step(fused_sampler=False,
fused_train_grad=False)`. The tiny scene, the draws taken from the JAX
step's keys and the tolerances are `test_torch_train_step.py`'s (its
module docstring gives their reasons); its config is rewritten here.

* idr, normal losses on and off: the spatial gradient is the radiance
  net's input either way (`returns_grad`, `renderer.py:294`), so both
  take the render core (K3-idr / K4-idr on the card), never the rev op;
* SH (degree 4, 16 view columns): the render core does not take the
  radiance net (`supports_render_core`), so the render points go through
  one rev op (K5/K6 on the card) and the eikonal points through a second
  (`renderer.py:378-387,471-478`), never the render core.
"""

import jax
import pytest

from i2sdf_tpu_torch.ops.kernels import render_core, rev
import test_torch_train_step as tts

IDR = ("mode: nerf\n        d_in: 3", "mode: idr\n        d_in: 9")
SH = ("embed_type: 'positional'\n        multires: 4",
      "embed_type: spherical_harmonics\n        multires: 4")


def _pair(tmp_path, monkeypatch, edit, normal=True):
    """`test_torch_train_step._pair` on its tiny scene with the config's
    radiance block rewritten by `edit` (old, new)."""
    write = tts.write_tiny_scene

    def write_edited(root, seed=0):
        path = write(root, seed)
        text = open(path).read()
        assert text.count(edit[0]) == 1
        with open(path, "w") as f:
            f.write(text.replace(*edit))
        return path

    monkeypatch.setattr(tts, "write_tiny_scene", write_edited)
    return tts._pair(tmp_path, False, normal=normal)


def _count(monkeypatch):
    """Record the rows of every rev op and render core call."""
    calls = {"rev": [], "core": []}
    sdf_outputs_rev, train = rev.sdf_outputs_rev, render_core.render_core_train

    def counted_rev(net, x, plain=False):
        calls["rev"].append(x.shape[0])
        return sdf_outputs_rev(net, x, plain=plain)

    def counted_core(icfg, rcfg, w, x, *a, **k):
        calls["core"].append(x.shape[0])
        return train(icfg, rcfg, w, x, *a, **k)

    monkeypatch.setattr(rev, "sdf_outputs_rev", counted_rev)
    monkeypatch.setattr(render_core, "render_core_train", counted_core)
    return calls


@pytest.mark.parametrize("normal", [True, False], ids=["normal", "nonormal"])
def test_train_step_idr_matches_jax(tmp_path, monkeypatch, normal):
    pair = _pair(tmp_path, monkeypatch, IDR, normal)
    tcfg = pair[4]
    assert tcfg.rendering.mode == "idr" and tcfg.use_normal == normal
    calls = _count(monkeypatch)
    m = tts._step_against_jax(*pair, jax.random.PRNGKey(21))
    assert calls["rev"] == [] and len(calls["core"]) == 3
    assert all(n == calls["core"][0] for n in calls["core"])
    assert (float(m["normal_loss"]) > 0) == normal


def test_train_step_sh_matches_jax(tmp_path, monkeypatch):
    pair = _pair(tmp_path, monkeypatch, SH)
    tcfg = pair[4]
    assert tcfg.rendering.embed_type == "spherical_harmonics"
    assert tcfg.rendering.layer_dims()[0] == 16 + 16
    calls = _count(monkeypatch)
    tts._step_against_jax(*pair, jax.random.PRNGKey(22))
    assert calls["core"] == []
    n_render = calls["rev"][0]
    assert calls["rev"] == [n_render, 3 * tts.BATCH] * 3
    assert n_render % tts.BATCH == 0 and n_render > 3 * tts.BATCH
