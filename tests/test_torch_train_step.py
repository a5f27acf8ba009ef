"""The port's training step against the JAX package's
`make_train_step(fused_sampler=False, fused_train_grad=False)`, on the
CPU, on a tiny scene written to `tmp_path` (two views of scan1 at 24 x 32
with `.npy` depth and normals, some of both invalid), at narrow widths
(SDF 4 x 64 with a skip, radiance 2 x 32, 16 features, the flagship's
sampler, 64 rays), with the same converted parameters and the same draws:
`jax_draws` rebuilds the JAX package's key layout (`fold_in(step)` ->
`split(3)` -> `split(4)` -> the sampler's `split(max_total_iters + 4)`,
and the bubble draw) and hands its numbers to the port.

Tolerances, with their reasons:
* loss terms to 2e-5 relative and the batch's step-0 gradients per leaf
  to 5e-4 of the leaf's largest entry (both f32; the JAX package's prefix
  sums are hi/lo-split bf16 matmuls and every sum runs in another order,
  and a sample that moves by a rounding step moves the rendered colour);
* parameters after 3 Adam steps: Adam normalizes each coordinate, and
  with eps 1e-15 a gradient at rounding level (~1e-9 of its leaf) still
  moves its coordinate by about the learning rate, in a direction the
  rounding decides. So each coordinate may differ by at most 2 x 3 x lr
  (two runs, three steps, one lr-sized step each at most, with Adam's
  early-step bound |m_hat / sqrt(v_hat)| <= 1), and 99% of the
  coordinates must agree to 1e-2 lr.

The other configurations' and routes' steps use this file's scene,
draws and tolerances from files of their own, so that the suite's
workers (`--dist loadfile`) run them side by side:
`test_torch_train_step_light.py` (the light-mask config),
`test_torch_train_step_nonormal_bubble.py` (the normal-loss-off route
and the bubble window) and `test_torch_train_step_bg_per_ray.py` (the
background and per-ray compaction).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.data.recon import ReconData as JReconData
from i2sdf_tpu.data.recon import sample_batch as jax_sample_batch
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu.models.losses import compute_losses as jax_losses
from i2sdf_tpu.train.state import create_train_state as jax_train_state
from i2sdf_tpu.train.step import make_train_step as jax_make_step
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.data.recon import ReconData
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.models.losses import LossConfig
from i2sdf_tpu_torch.models.sampler import SamplerDraws
from i2sdf_tpu_torch.params import from_jax_params
from i2sdf_tpu_torch.train import step as tstep
from i2sdf_tpu_torch.train.state import create_train_state
from i2sdf_tpu_torch.utils import imaging as timaging
from test_torch_helpers import to_numpy
from test_torch_slice import _tiny_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64
LR = 5e-4


def write_tiny_scene(root, seed=0):
    """Two 24 x 32 views of scan1 with `.npy` depth (a corner invalid) and
    normals (a few zero or NaN); returns the config's path."""
    _tiny_scene(root)
    scan = os.path.join(root, "tiny", "scan0")
    rng = np.random.default_rng(seed)
    for sub in ("depth", "normal"):
        os.makedirs(os.path.join(scan, sub))
    for i in range(2):
        depth = rng.uniform(1.0, 4.0, (24, 32)).astype(np.float32)
        depth[:3, :4] = 0.0
        np.save(os.path.join(scan, "depth", f"{i:04d}.npy"), depth)
        n = rng.normal(size=(24, 32, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        n[5, :3] = 0.0
        n[6, 2] = np.nan
        np.save(os.path.join(scan, "normal", f"{i:04d}.npy"), n)
    text = open(os.path.join(ROOT, "configs", "synthetic_quality.yml")).read()
    text = (text.replace("dims: [256, 256, 256, 256, 256, 256, 256, 256]",
                         "dims: [64, 64, 64, 64]")
            .replace("skip_in: [4]", "skip_in: [2]")
            .replace("dims: [256, 256, 256, 256]", "dims: [32, 32]")
            .replace("feature_vector_size: 256", "feature_vector_size: 16")
            .replace("data_dir: synthetic_quality", "data_dir: tiny")
            .replace("downsample: 2", "downsample: 1")
            .replace("batch_size: 1600", f"batch_size: {BATCH}")
            .replace("split_n_pixels: 12000", "split_n_pixels: 768")
            .replace("min_bubble_iter: 50000", "min_bubble_iter: 0")
            .replace("max_bubble_iter: 150000", "max_bubble_iter: 10"))
    path = os.path.join(root, "tiny.yml")
    with open(path, "w") as f:
        f.write(text)
    return path


def write_light_scene(root, seed=0):
    """The tiny scene with seeded grey PNG light masks (0 or 255, a third
    of the pixels lit), and its config turned into the light-mask
    config's shape: a light head 16 -> 16 -> 1 and the light-mask loss at
    the light config's weight. Returns the config's path."""
    path = write_tiny_scene(root, seed)
    scan = os.path.join(root, "tiny", "scan0", "light_mask")
    os.makedirs(scan)
    rng = np.random.default_rng(seed + 1)
    for i in range(2):
        lit = rng.uniform(size=(24, 32)) < 1 / 3
        timaging.write_png(os.path.join(scan, f"{i:04d}.png"),
                           (lit * 255).astype(np.uint8))
    text = (open(path).read()
            .replace("    bubble_weight: 0.5\n",
                     "    bubble_weight: 0.5\n    light_mask_weight: 0.5\n")
            .replace("    density:\n", "    light_network:\n"
                     "        dims: [16]\n        weight_norm: True\n\n"
                     "    density:\n"))
    assert "light_network" in text and "light_mask_weight" in text
    with open(path, "w") as f:
        f.write(text)
    return path


# a background block (`model.bg_network`) at narrow widths: the NeRF++
# nets of VolSDF's BlendedMVS config in shape, with a smaller encoding
BG_BLOCK = """    bg_network:
        feature_vector_size: 16
        implicit_network:
            d_in: 4
            d_out: 1
            dims: [48, 48, 48]
            geometric_init: False
            skip_in: [2]
            weight_norm: False
            embed_type: positional
            multires: 4
        rendering_network:
            mode: nerf
            d_in: 3
            d_out: 3
            dims: [16]
            weight_norm: False
            embed_type: positional
            multires: 4

"""
PER_RAY_FRACS = (1.0, 0.5, 0.5, 0.5)


def _jax_draw_bubble(pdf, k_bubble, n_draws):
    """`i2sdf_tpu/train/step.py:124-146` (a closure there)."""
    n_buckets = 4096
    pdf2d = jnp.pad(pdf, (0, (-pdf.shape[0]) % n_buckets)).reshape(
        n_buckets, -1)
    per = pdf2d.shape[1]
    k_b, k_w = jax.random.split(k_bubble)
    mass = pdf2d.sum(-1)
    log_mass = jnp.where(mass > 0, jnp.log(jnp.maximum(mass, 1e-20)),
                         -jnp.inf)
    b = jax.random.categorical(k_b, log_mass, shape=(n_draws,))
    rows = pdf2d[b]
    log_rows = jnp.where(rows > 0, jnp.log(jnp.maximum(rows, 1e-20)),
                         -jnp.inf)
    w = jax.random.categorical(k_w, log_rows, axis=-1)
    return jnp.minimum(b * per + w, pdf.shape[0] - 1)


def jax_draws(jcfg, jdata, base_key, step, pdf=None):
    """The JAX step's random numbers at `step`, as a port `TrainDraws`."""
    sc = jcfg.sampler
    key = jax.random.fold_in(base_key, step)
    k_batch, k_bubble, k_render = jax.random.split(key, 3)
    idx, _, _ = jax_sample_batch(jdata, k_batch, BATCH)
    k_sampler, k_eik, k_jitter, _ = jax.random.split(k_render, 4)
    keys = jax.random.split(k_sampler, sc.max_total_iters + 4)
    counts, R = sc.eval_counts, BATCH
    perm = jax.random.permutation(keys[-3], sum(counts))
    s = jcfg.scene_bounding_sphere
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.array(a)).to(dt)
    draws = tstep.TrainDraws(
        batch_idx=t(idx, torch.int64),
        render=renderer.RenderDraws(
            sampler=SamplerDraws(
                strat=t(jax.random.uniform(keys[0], (R, counts[0]))),
                final=t(jax.random.uniform(keys[sc.max_total_iters],
                                           (R, sc.N_samples + 1))),
                extra_idx=t(jnp.sort(perm[:sc.N_samples_extra]),
                            torch.int64),
                eik_idx=t(jax.random.randint(keys[-2], (R, 1), 0,
                                             sc.total_fg_samples),
                          torch.int64)),
            eik_uniform=t(jax.random.uniform(k_eik, (R, 3), minval=-s,
                                             maxval=s)),
            jitter=t(jax.random.uniform(k_jitter, (R, 3), minval=-0.005,
                                        maxval=0.005))))
    if sc.inverse_sphere_bg:
        draws.render.sampler.bg = t(jax.random.uniform(
            keys[-1], (R, sc.N_samples_inverse_sphere)))
    if pdf is not None:
        draws.bubble_idx = t(_jax_draw_bubble(pdf, k_bubble, BATCH),
                             torch.int64)
    return draws


def _pair(tmp_path, bubble, normal=True, light=False, detach=True, bg=False,
          per_ray=False):
    """Both packages' model, parameters and data on the tiny scene. With
    `normal` off the normal loss weight is 0 and the scene's normal maps
    are overwritten with bytes no loader can parse, so a loader that read
    one would fail. With `light`, the light-mask config's shape and the
    scene's light masks (`write_light_scene`), and `detach` written into
    its config as `model.detach_light_feature`. With `bg`, the
    background block `BG_BLOCK`; with `per_ray`, the sampler's per-ray
    compaction at the pinned `PER_RAY_FRACS`."""
    path = (write_light_scene if light else write_tiny_scene)(str(tmp_path))
    text = open(path).read()
    if bg:
        text = text.replace("    density:\n", BG_BLOCK + "    density:\n")
    if per_ray:
        text = text.replace(
            "    ray_sampler:\n", "    ray_sampler:\n        per_ray_exit: "
            f"True\n        per_ray_fracs: {list(PER_RAY_FRACS)}\n")
    with open(path, "w") as f:
        f.write(text)
    if not normal:
        ndir = os.path.join(str(tmp_path), "tiny", "scan0", "normal")
        for name in os.listdir(ndir):
            with open(os.path.join(ndir, name), "wb") as f:
                f.write(b"not a normal map")
        text = open(path).read().replace("normal_weight: 0.05",
                                         "normal_weight: 0.0")
        with open(path, "w") as f:
            f.write(text)
    if not detach:
        text = open(path).read().replace(
            "    light_network:\n",
            "    detach_light_feature: False\n    light_network:\n")
        assert "detach_light_feature: False" in text
        with open(path, "w") as f:
            f.write(text)
    jc, tc = jax_load_cfg(path), load_cfg(path)
    for c in (jc, tc):
        c.model.use_normal = normal
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jc.model)
    tcfg = renderer.I2SDFConfig.from_cfgnode(tc.model)
    params = jrenderer.init(jax.random.PRNGKey(0), jcfg)
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(to_numpy(params), tcfg))
    kw = dict(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
              use_depth=True, use_normal=normal, use_bubble=bubble,
              use_lightmask=light, pdf_prune=0.05, pdf_max=0.2)
    return (jcfg, params, JReconData(**kw).to_device(),
            LossConfig.from_cfgnode(tc.loss), tcfg, model,
            ReconData(**kw).to_device("cpu"))


def _flat_params(tree):
    return {f"{net}.{lin}.{leaf}": np.asarray(v)
            for net in ("implicit", "rendering", "light", "bg_implicit",
                        "bg_rendering") if net in tree
            for lin, leaves in tree[net].items()
            for leaf, v in leaves.items()} | {"beta": np.asarray(
                tree["beta"])}


def _step_against_jax(jcfg, params, jdata, lcfg, tcfg, model, data, base):
    """Step 0's loss terms and gradients, then the parameters after 3
    steps of each package's own step, against the JAX package's (the
    module docstring's tolerances); returns the port's step-0 metrics."""
    weights = lcfg.dynamic_weights(0)
    jw = {k: jnp.float32(v) for k, v in weights.items()}

    # step-0 loss terms and gradients
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
    state = create_train_state(model, learning_rate=LR, decay_steps=200_000)
    step = tstep.make_train_step(tcfg, BATCH)
    metrics = step(state, data, jax_draws(jcfg, jdata, base, 0), weights)
    for k, v in jterms.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=2e-5,
                                                  abs=1e-7), k
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    for k, ref in _flat_params(jgrads).items():
        scale = max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=5e-4 * scale,
                                   err_msg=k)

    # parameters after 3 steps of each package's own step
    jstate, tx = jax_train_state(params, learning_rate=LR,
                                 decay_steps=200_000)
    jstep = jax_make_step(jcfg, tx, BATCH, fused_sampler=False,
                          fused_train_grad=False, donate=False)
    for t in range(3):
        jstate, _ = jstep(jstate, jdata, base, jw)
        if t:
            step(state, data, jax_draws(jcfg, jdata, base, t), weights)
    assert state.step == 3 and int(jstate.step) == 3
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    diffs = []
    for k, ref in _flat_params(to_numpy(jstate.params)).items():
        d = np.abs(got[k] - ref).ravel()
        assert d.max() <= 2 * 3 * LR, (k, d.max())
        diffs.append(d)
    assert np.quantile(np.concatenate(diffs), 0.99) <= 1e-2 * LR
    return metrics


def test_train_step_matches_jax(tmp_path):
    _step_against_jax(*_pair(tmp_path, False), jax.random.PRNGKey(7))


def test_bubble_queue_matches_live_draw():
    """`bubble_draw_every=2`: step 0 takes the first half of a queue drawn
    from the live pdf, identical to the live draw of step 0; step 1 takes
    the second half, drawn from step 0's pdf (stale by one update)."""
    gen = torch.Generator().manual_seed(0)
    P, bs = 10_000, 64
    pdf0 = torch.rand(P, generator=gen) * (torch.rand(P, generator=gen) > 0.5)
    u = torch.rand((2 * bs, 2), generator=gen)
    live = tstep.draw_bubble(pdf0, u[:bs])
    queue = tstep.draw_bubble(pdf0, u)
    assert torch.equal(queue[:bs], live)
    assert (pdf0[live] > 0).all()
    # through the step's queue logic
    bub = tstep.BubbleState(pdf=pdf0, sample_count=torch.zeros(P))
    every = 2
    for t in range(2):
        pos = bub.queue_pos % every
        if pos == 0:
            bub.queue = tstep.draw_bubble(bub.pdf, u[:every * bs])
        got = bub.queue[pos * bs:(pos + 1) * bs]
        bub.queue_pos += 1
        assert torch.equal(got, queue[t * bs:(t + 1) * bs])
        bub.pdf = torch.rand(P, generator=gen)  # the step's pdf update


def test_bubble_draw_follows_the_pdf():
    gen = torch.Generator().manual_seed(1)
    P = 9_000  # not a multiple of the bucket count
    pdf = torch.zeros(P)
    pdf[[3, 4097, 8999]] = torch.tensor([1.0, 2.0, 5.0])
    idx = tstep.draw_bubble(pdf, torch.rand((80_000, 2), generator=gen))
    freq = torch.bincount(idx, minlength=P).float() / idx.numel()
    assert set(torch.nonzero(freq).flatten().tolist()) == {3, 4097, 8999}
    torch.testing.assert_close(freq[[3, 4097, 8999]],
                               torch.tensor([0.125, 0.25, 0.625]),
                               atol=0.01, rtol=0)
