"""Training step and chunked eval render (counterpart of
`i2sdf_tpu/train/step.py`).

`make_train_step` returns the step the JAX package jits
(`step.py:101-247`): the ray-batch gather (with the light-mask target in
the light-mask config), the bubble draw (in the window), the training
render, the losses, the backward (K4 on the card), Adam, and the
point-cloud pdf update with its sample counts. `make_eval_render_fn`
renders a whole image in chunks; its output holds the light mask too when
the model has a light head. PyTorch runs it eagerly. With per-ray sampler
compaction the capacities follow the learned beta (`PER_RAY_PHASES`,
`step.py:35-83`): the trainer builds the step of the current phase
(`cfg_with_fracs`), and the eval render picks its own, unless the config
pins `per_ray_fracs`. The step's random numbers arrive in a `TrainDraws`
bundle, drawn by default from a `torch.Generator` seeded with (seed,
step), so a resumed run replays the draws an uninterrupted run would have
made.

Host syncs of one step: the sampler's global or per-ray early exit reads
one flag per refinement round (up to `max_total_iters - 1` = 4 at the
flagship config, `models/sampler.py`; none with `early_exit: false`).
Nothing else in the step waits for the card; the metrics stay on the
device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.recon import DeviceArrays, sample_batch
from ..models import renderer
from ..models.density import effective_beta
from ..models.losses import compute_losses
from .state import TrainState

N_BUCKETS = 4096  # the two-stage bubble draw's first stage (step.py:124-146)

# Per-ray compaction phases (`step.py:35-58`): (beta floor, per_ray_fracs),
# the first row whose floor is below beta wins; None is the plain global
# early exit. Each cap is the unconverged fraction the JAX package measured
# at that beta plus a margin.
PER_RAY_PHASES = (
    (0.05, None),
    (0.02, (1.0, 1.0, 1.0, 0.77)),
    (0.005, (1.0, 1.0, 1.0, 0.66)),
    (0.002, (1.0, 1.0, 1.0, 0.85)),
    (0.0, None),
)


def per_ray_fracs_for_beta(beta: float):
    """The capacity phase for the learned beta (`step.py:60-65`)."""
    for floor, fracs in PER_RAY_PHASES:
        if beta > floor:
            return fracs
    return PER_RAY_PHASES[-1][1]


def cfg_with_fracs(model_cfg: renderer.I2SDFConfig,
                   fracs) -> renderer.I2SDFConfig:
    """The model config with its sampler in a per-ray capacity phase (None:
    the plain global early exit; `step.py:68-83`)."""
    sc = model_cfg.sampler
    if fracs is None:
        if not sc.per_ray_exit:
            return model_cfg
        sc = dataclasses.replace(sc, per_ray_exit=False)
    else:
        sc = dataclasses.replace(sc, per_ray_exit=True,
                                 per_ray_fracs=tuple(fracs))
    return dataclasses.replace(model_cfg, sampler=sc)


def eval_fracs(model: renderer.I2SDFModel):
    """The eval render's per-ray phase (`step.py:282-292`): the pinned
    fractions, else the beta ladder's; None without per-ray compaction."""
    sc = model.cfg.sampler
    if not sc.per_ray_exit:
        return None
    if sc.per_ray_fracs is not None:
        return tuple(sc.per_ray_fracs)
    beta = float(effective_beta(model.beta.detach(), model.cfg.beta_min))
    return per_ray_fracs_for_beta(beta)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws: a function of (seed, step)."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (1 << 63))


@dataclasses.dataclass
class TrainDraws:
    """The random numbers of one training step."""
    batch_idx: torch.Tensor        # (B,) int64 flat (image, pixel) indices
    render: renderer.RenderDraws
    bubble_u: torch.Tensor | None = None   # (K * Bb, 2) U[0, 1): bucket
    #                                        and in-bucket uniforms
    bubble_idx: torch.Tensor | None = None  # (Bb,) int64: given bubble
    #                                         points (overrides bubble_u)

    @classmethod
    def sample(cls, cfg: renderer.I2SDFConfig, data: DeviceArrays,
               batch_size: int, gen: torch.Generator,
               bubble_draws: int = 0) -> "TrainDraws":
        n = data.rgb.shape[0] * data.rgb.shape[1]
        dev = gen.device
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
        rd = renderer.RenderDraws.sample(cfg, batch_size, gen)
        u = (torch.rand((bubble_draws, 2), generator=gen, device=dev)
             if bubble_draws else None)
        return cls(batch_idx=idx, render=rd, bubble_u=u)


def draw_bubble(pdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Point indices drawn with replacement from the (unnormalized) pdf,
    two-stage as `step.py:124-146`: a bucket by its mass, then a point in
    the bucket by its weight. Here each stage inverts the CDF at the
    given uniforms (the JAX package takes Gumbel-max draws: the same law,
    other numbers). u: (n, 2) -> (n,) int64."""
    P = pdf.shape[0]
    pad = (-P) % N_BUCKETS
    pdf2d = torch.cat([pdf, pdf.new_zeros(pad)]).reshape(N_BUCKETS, -1)
    per = pdf2d.shape[1]
    cdf = torch.cumsum(pdf2d.sum(-1), 0)
    b = torch.searchsorted(cdf, (u[:, 0] * cdf[-1]).contiguous(),
                           right=True)
    b = torch.clamp(b, max=N_BUCKETS - 1)
    rows = torch.cumsum(pdf2d[b], -1)
    w = torch.searchsorted(rows, (u[:, 1:] * rows[:, -1:]).contiguous(),
                           right=True)[:, 0]
    w = torch.clamp(w, max=per - 1)
    return torch.clamp(b * per + w, max=P - 1)


@dataclasses.dataclass
class BubbleState:
    """The bubble window's device state (`trainer.py:309-350`)."""
    pdf: torch.Tensor            # (P,) f32
    sample_count: torch.Tensor   # (P,) int64
    queue: torch.Tensor | None = None   # (K * Bb,) drawn ahead, K > 1
    queue_pos: int = 0


def update_pdf(pdf, pointlinks, flat_indices, values, pdf_prune: float,
               pdf_max: float | None):
    """Scatter per-pixel errors into the point-cloud pdf
    (`step.py:185-193`): clamp to pdf_max, zero below pdf_prune, route
    through pointlinks; pixels without a point (-1) are dropped."""
    if pdf_max is not None:
        values = torch.clamp(values, max=pdf_max)
    values = torch.where(values < pdf_prune, torch.zeros_like(values),
                         values)
    links = pointlinks[flat_indices]
    keep = links >= 0
    pdf = pdf.clone()
    pdf[links[keep]] = values[keep]
    return pdf


def make_train_step(cfg: renderer.I2SDFConfig, batch_size: int,
                    bubble_batch_size: int | None = None,
                    pdf_prune: float = 0.0, pdf_max: float | None = None,
                    pdf_criterion: str = "DEPTH",
                    angular_reference_bug: bool = False,
                    bubble_draw_every: int = 1, plain: bool = False):
    """The training step.

        step(state, data, draws, weights, bubble=None) -> metrics

    `bubble` (a `BubbleState`, in the window) is updated in place: the
    draw (every `bubble_draw_every`-th step K * Bb indices ahead, sliced
    per step, as `step.py:219-233`), the pdf scatter and the sample
    counts. `metrics` are 0-d device tensors: the loss, its nine terms and
    the batch PSNR. `plain=True` takes the plain versions of the kernels
    on any device. The render samples with `cfg.sampler` (a per-ray
    phase's, from `cfg_with_fracs`)."""
    bubble_bs = bubble_batch_size or batch_size
    every = max(int(bubble_draw_every), 1)
    if pdf_criterion not in ("DEPTH", "RGB"):
        raise ValueError(f"pdf_criterion {pdf_criterion!r}")

    def step(state: TrainState, data: DeviceArrays, draws: TrainDraws,
             weights: dict, bubble: BubbleState | None = None) -> dict:
        model = state.model
        inputs, gt = sample_batch(data, draws.batch_idx)
        bubble_idx = None
        if bubble is not None:
            if draws.bubble_idx is not None:
                bubble_idx = draws.bubble_idx
            elif every == 1:
                bubble_idx = draw_bubble(bubble.pdf,
                                         draws.bubble_u[:bubble_bs])
            else:
                pos = bubble.queue_pos % every
                if pos == 0:
                    bubble.queue = draw_bubble(
                        bubble.pdf, draws.bubble_u[:every * bubble_bs])
                bubble_idx = bubble.queue[pos * bubble_bs:
                                          (pos + 1) * bubble_bs]
                bubble.queue_pos += 1
            inputs["pointcloud"] = data.pointcloud[bubble_idx]
        out = renderer.render_rays_train(model, inputs, draws.render,
                                         plain=plain, sampler=cfg.sampler)
        terms = compute_losses(out, gt, weights,
                               angular_reference_bug=angular_reference_bug)
        state.optimizer.zero_grad(set_to_none=True)
        terms["loss"].backward()
        state.apply_gradients()
        metrics = {k: v.detach() for k, v in terms.items()}
        with torch.no_grad():
            mse = ((out["rgb_values"] - gt["rgb"].reshape(-1, 3)) ** 2).mean()
            metrics["psnr"] = -10.0 * torch.log10(mse)
            if bubble is not None:
                if pdf_criterion == "DEPTH":
                    crit = (out["depth_values"] - gt["depth"]).abs()
                else:
                    crit = (out["rgb_values"].clamp(0, 1)
                            - gt["rgb"].clamp(0, 1)).abs().mean(-1)
                bubble.pdf = update_pdf(bubble.pdf, data.pointlinks,
                                        draws.batch_idx, crit, pdf_prune,
                                        pdf_max)
                bubble.sample_count = bubble.sample_count.index_add(
                    0, bubble_idx, torch.ones_like(bubble_idx))
        return metrics

    return step


def make_eval_render_fn(model: renderer.I2SDFModel, chunk_size: int):
    """Returns render_image(uv (HW, 2), intrinsics (4, 4), pose (4, 4)) ->
    dict of (HW, ...) tensors. The image is cut into `chunk_size`-ray
    chunks (the last one zero-padded, as the reference pads it), each
    rendered by `render_rays`; the kernels' weights are packed once. With
    per-ray compaction each image samples in the phase of `eval_fracs`."""
    weights = renderer.KernelWeights.pack(model)

    def render_image(uv: torch.Tensor, intrinsics: torch.Tensor,
                     pose: torch.Tensor) -> dict:
        sampler = cfg_with_fracs(model.cfg, eval_fracs(model)).sampler
        n = uv.shape[0]
        n_pad = (-n) % chunk_size
        uv_p = torch.cat([uv, uv.new_zeros((n_pad, 2))]) if n_pad else uv
        outs = []
        for chunk in uv_p.split(chunk_size):
            outs.append(renderer.render_rays(
                model, {"uv": chunk[None], "intrinsics": intrinsics[None],
                        "pose": pose[None]}, weights=weights,
                sampler=sampler))
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}

    return render_image
