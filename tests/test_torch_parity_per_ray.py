"""Per-ray sampler compaction (`models/sampler.py::error_bound_z_vals` with
`per_ray_exit`, and `early_exit: false`) and its capacity phases
(`train/step.py`, `train/trainer.py`), against the JAX package.

The sampler runs on an analytic sphere SDF in both packages, at eval and
in training; the training draws are taken from the JAX sampler's own keys
(`split(key, max_total_iters + 4)`: the stratified init from key 0, the
final round's uniforms from key `max_total_iters`, the extras' permutation
from key -3, the eikonal index from key -2). Depths agree to 1e-4 on [0,
6], the sampler parity tolerance of `test_torch_parity_sampler.py` (the
JAX prefix sums are hi/lo-split bf16 matmuls, the port's f32 cumsums).
The four cases:

* `rotation`: rays into the sphere at beta0 0.01 do not converge and the
  caps (half the rays) are below the unconverged count, so the rotated
  tie-break picks another half each round (`tests/test_sampler.py:232`);
* `all_converged`: every ray converges in round 0 (eps 1e9): the
  compacted rounds emit leading-column copies and skip the SDF;
* `none_converged`: the same rays over four rounds, the first refinement
  round full and the later ones compacted, with a tapering per-round
  budget;
* `no_early_exit`: `early_exit: false`, every round on every ray.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.models import sampler as jsampler
from i2sdf_tpu.train import step as jstep
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.models import sampler as tsampler
from i2sdf_tpu_torch.train import step as tstep
from i2sdf_tpu_torch.train.trainer import ReconstructionTrainer
from test_torch_train_step import write_tiny_scene

BASE = dict(scene_bounding_sphere=3.0, N_samples=16, N_samples_eval=32,
            N_samples_extra=8, eps=0.1, beta_iters=6, max_total_iters=3,
            add_tiny=1e-6)
CASES = {
    "rotation": dict(per_ray_exit=True, per_ray_fracs=(0.5,)),
    "all_converged": dict(eps=1e9, per_ray_exit=True, per_ray_fracs=(0.5,)),
    "none_converged": dict(per_ray_exit=True, max_total_iters=4,
                           per_ray_fracs=(1.0, 0.5, 0.5),
                           round_eval_counts=(32, 24, 16, 16)),
    "no_early_exit": dict(per_ray_exit=True, early_exit=False,
                          per_ray_fracs=(0.5,)),
}


def rays(n, hit, seed=3):
    """Rays from z = -2.5 toward a sphere of radius 1 at the origin; `hit`
    aims them at its centre region, else they pass 2 units to the side."""
    rng = np.random.default_rng(seed)
    cam = np.zeros((n, 3), np.float32)
    cam[:, 2] = -2.5
    target = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    target[:, 2] = 0.0
    if not hit:
        target[:, 0] += 2.0
    d = target - cam
    return cam, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def sampler_draws(jcfg, key, R):
    """The JAX sampler's training draws at `key`, as a port SamplerDraws."""
    keys = jax.random.split(key, jcfg.max_total_iters + 4)
    counts = jcfg.eval_counts
    perm = jax.random.permutation(keys[-3], sum(counts))
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.array(a)).to(dt)
    return tsampler.SamplerDraws(
        strat=t(jax.random.uniform(keys[0], (R, counts[0]))),
        final=t(jax.random.uniform(keys[jcfg.max_total_iters],
                                   (R, jcfg.N_samples + 1))),
        extra_idx=t(jnp.sort(perm[:jcfg.N_samples_extra]), torch.int64),
        eik_idx=t(jax.random.randint(keys[-2], (R, 1), 0,
                                     jcfg.total_fg_samples), torch.int64),
        bg=(t(jax.random.uniform(keys[-1],
                                 (R, jcfg.N_samples_inverse_sphere)))
            if jcfg.inverse_sphere_bg else None))


def both_samplers(jcfg, tcfg, dirs, cam, beta0, training, key):
    """(JAX (z, z_bg), port (z, z_bg), the port's SDF batch sizes)."""
    R = dirs.shape[0]
    ref = jax.jit(lambda d, c: jsampler.error_bound_z_vals(
        jcfg, lambda p: jnp.linalg.norm(p, axis=-1) - 1.0, key, d, c, beta0,
        training=training)[:2])(dirs, cam)
    calls = []

    def sdf_fn(p):
        calls.append(p.shape[0])
        return torch.linalg.norm(p, dim=-1) - 1.0

    got = tsampler.error_bound_z_vals(
        tcfg, sdf_fn, torch.from_numpy(dirs), torch.from_numpy(cam),
        torch.tensor(beta0),
        draws=sampler_draws(jcfg, key, R) if training else None)
    return ref, got, calls


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_per_ray_sampler_matches_jax(case, training):
    kw = {**BASE, **CASES[case]}
    jcfg = jsampler.SamplerConfig(**kw)
    tcfg = tsampler.SamplerConfig(**kw)
    R = 24
    cam, dirs = rays(R, hit=case != "all_converged")
    beta0 = np.float32(0.01)
    (z_ref, _), (z, z_bg), calls = both_samplers(
        jcfg, tcfg, dirs, cam, beta0, training, jax.random.PRNGKey(5))
    assert z_bg is None
    assert z.shape == z_ref.shape == (R, tcfg.total_fg_samples)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4)
    assert (torch.diff(z, dim=-1) >= 0).all()
    counts = tcfg.eval_counts
    caps = tsampler.per_ray_caps(tcfg, R)
    if case == "all_converged":   # round 0 only
        assert calls == [R * counts[0]]
    elif case == "no_early_exit":  # every round on every ray
        assert calls == [R * c for c in counts]
    else:   # round 0 full, then the capped rounds
        assert caps[-1] < R
        assert calls == [R * counts[0]] + [
            c * n for c, n in zip(caps, counts[1:])], (calls, caps)


def test_per_ray_conv_impl_is_called_each_refinement_round():
    """The sampler takes its convergence flags from `conv_impl` (K7 on the
    card): once a refinement round, on the refined rows only after a
    compacted round."""
    kw = {**BASE, **CASES["rotation"], "max_total_iters": 4}
    tcfg = tsampler.SamplerConfig(**kw)
    cam, dirs = rays(16, hit=True)
    seen = []

    def conv(z, s, b0):
        seen.append(z.shape)
        return tsampler.converged_rays(tcfg, z, s, b0)

    tsampler.error_bound_z_vals(
        tcfg, lambda p: torch.linalg.norm(p, dim=-1) - 1.0,
        torch.from_numpy(dirs), torch.from_numpy(cam), torch.tensor(0.01),
        conv_impl=conv)
    c = tcfg.eval_counts[0]
    assert seen == [(16, c), (8, 2 * c), (8, 3 * c)], seen


def test_per_ray_phases_match_jax():
    """The capacity ladder over a beta grid, and the config a phase makes,
    against `i2sdf_tpu/train/step.py:35-83`; a pinned tuple wins at every
    beta in the eval render's choice."""
    assert tstep.PER_RAY_PHASES == jstep.PER_RAY_PHASES
    for beta in np.geomspace(1e-5, 1.0, 61).tolist() + [0.05, 0.02, 0.005,
                                                         0.002, 0.0]:
        assert (tstep.per_ray_fracs_for_beta(beta)
                == jstep.per_ray_fracs_for_beta(beta)), beta
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "synthetic_quality.yml")
    conf = load_cfg(path)
    conf.model.ray_sampler.per_ray_exit = True
    cfg = renderer.I2SDFConfig.from_cfgnode(conf.model)
    assert cfg.sampler.per_ray_exit and cfg.sampler.per_ray_fracs is None
    # the sampler keys the config accepts: pinned fractions, early_exit
    conf.model.ray_sampler.per_ray_fracs = [1.0, 0.5]
    conf.model.ray_sampler.early_exit = False
    pinned_cfg = renderer.I2SDFConfig.from_cfgnode(conf.model)
    assert pinned_cfg.sampler.per_ray_fracs == (1.0, 0.5)
    assert not pinned_cfg.sampler.early_exit and cfg.sampler.early_exit
    for fracs in (None, (1.0, 1.0, 1.0, 0.77)):
        got = tstep.cfg_with_fracs(cfg, fracs).sampler
        assert got.per_ray_exit == (fracs is not None)
        assert got.per_ray_fracs == (fracs if fracs else None)
        assert dataclasses.replace(got, per_ray_exit=True,
                                   per_ray_fracs=None) == cfg.sampler
    plain = dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler, per_ray_exit=False))
    assert tstep.cfg_with_fracs(plain, None) is plain
    model = renderer.I2SDFModel(cfg)
    assert tstep.eval_fracs(model) is None   # beta 0.1
    with torch.no_grad():
        model.beta.fill_(0.01)
    assert tstep.eval_fracs(model) == (1.0, 1.0, 1.0, 0.66)
    pinned = renderer.I2SDFModel(tstep.cfg_with_fracs(cfg, (0.5,)))
    assert tstep.eval_fracs(pinned) == (0.5,)


def test_trainer_swaps_the_per_ray_phase(tmp_path, monkeypatch):
    """The trainer picks the phase from the learned beta at the start of
    `fit` and every `per_ray_check_freq` steps (2 here): with beta set
    below 0.05 during step 0, steps 0 and 1 sample with the global exit
    and step 2 in the compacted phase of beta ~0.03."""
    path = write_tiny_scene(str(tmp_path))
    conf = load_cfg(path)
    conf.model.ray_sampler.per_ray_exit = True
    conf.train.per_ray_check_freq = 2
    conf.loss.min_bubble_iter = 1000
    tr = ReconstructionTrainer(conf, str(tmp_path / "exp"),
                               data_root=str(tmp_path), device="cpu")
    assert tr.per_ray and tr.per_ray_fracs is None
    # the validation render and the checkpoint are not under test here
    monkeypatch.setattr(tr, "validate", lambda step: None)
    monkeypatch.setattr(tr, "save_checkpoint", lambda: None)
    seen = []
    inner = renderer.render_rays_train

    def spy(model, inputs, draws, plain=False, sampler=None):
        if not seen:
            with torch.no_grad():
                model.beta.fill_(0.03)
        seen.append((sampler.per_ray_exit, sampler.per_ray_fracs))
        return inner(model, inputs, draws, plain=plain, sampler=sampler)

    monkeypatch.setattr(renderer, "render_rays_train", spy)
    tr.fit(max_steps=3, log_every=10)
    assert seen == [(False, None), (False, None),
                    (True, (1.0, 1.0, 1.0, 0.77))], seen
    assert tr.per_ray_fracs == (1.0, 1.0, 1.0, 0.77)
