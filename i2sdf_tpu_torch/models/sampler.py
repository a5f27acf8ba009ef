"""Error-bounded ray sampler (counterpart of `i2sdf_tpu/models/sampler.py`,
VolSDF Algorithm 1).

Ported: `SamplerConfig`, `uniform_z_vals` (with the far depth from the
scene sphere under the NeRF++ background, `sampler.py:134-148`),
`round_update` (one refinement round: d* bound, beta bisection, weights,
error-bound or final pdf, inverse CDF) and `error_bound_z_vals` on all
three of its branches, at eval and in training:

* the global early exit (`early_exit`, the default; `sampler.py:286-446`);
* per-ray compaction (`per_ray_exit`, `sampler.py:331-491`): each
  refinement round checks every ray's error bound at beta0 (`conv_impl`,
  K7 on the card), and the next round runs on at most `ceil(frac * R)`
  rays, the unconverged first with a per-round rotated tie-break; the
  other rows widen with copies of their far depth;
* `early_exit: false`: every round runs on every ray, with no host sync.

With `inverse_sphere_bg` the sampler also returns the NeRF++ background's
inverse depths (`sampler.py:534-542`). The training draws (`SamplerDraws`:
the stratified init `sampler.py:134-148`, the final round's sorted
uniforms `:188-196`, the sorted subset of the accumulated samples
`:510-516`, the eikonal depth index `:530-532`, the background's
stratification `:539-541`) are passed in, so a test can hand both
packages the same numbers.

`round_update` is the plain version of the CUDA sampler-round kernel
(`ops/kernels/sampler_round.py`), which is the production `round_impl`;
`converged_rays` is the plain version of the convergence-check kernel
(`ops/kernels/conv_check.py`), the production `conv_impl`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..ops.sampling import (linear_z_vals, pdf_to_cdf, prefix_sum,
                            sample_cdf, stratify)
from ..utils.cameras import get_sphere_intersections
from .density import laplace_density

# capacities of a per-ray sampler with no fractions given
DEFAULT_PER_RAY_FRACS = (1.0, 0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    scene_bounding_sphere: float = 3.0
    near: float = 0.0
    N_samples: int = 64
    N_samples_eval: int = 128
    N_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5
    inverse_sphere_bg: bool = False
    N_samples_inverse_sphere: int = 32
    add_tiny: float = 1e-6
    early_exit: bool = True
    # per-ray compaction: `per_ray_fracs[i]` caps refinement round i + 1
    # to ceil(frac * R) rays (a short tuple repeats its last entry; a
    # fraction >= 1 keeps the round full); None means the trainer's
    # beta-phased ladder (`train/step.py::PER_RAY_PHASES`)
    per_ray_exit: bool = False
    per_ray_fracs: tuple | None = None
    round_eval_counts: tuple | None = None

    @property
    def eval_counts(self) -> tuple:
        """Per-round evaluated-point counts, length max_total_iters."""
        if self.round_eval_counts is None:
            return (self.N_samples_eval,) * self.max_total_iters
        counts = tuple(int(c) for c in self.round_eval_counts)
        if len(counts) != self.max_total_iters:
            raise ValueError(
                f"round_eval_counts needs {self.max_total_iters} entries, "
                f"got {len(counts)}")
        return counts

    @property
    def far(self) -> float:
        return 2.0 * self.scene_bounding_sphere

    @property
    def total_fg_samples(self) -> int:
        """Final per-ray sample count incl. the near and far columns."""
        return self.N_samples + self.N_samples_extra + 2


@dataclasses.dataclass
class SamplerDraws:
    """The random numbers of one training render's sampler (R rays)."""
    strat: torch.Tensor      # (R, counts[0]) U[0, 1): stratified init jitter
    final: torch.Tensor      # (R, N_samples + 1) U[0, 1): the final round's
    #                          sorted uniforms (`_sorted_uniform`)
    extra_idx: torch.Tensor  # (N_samples_extra,) int64, sorted: the subset
    #                          of the accumulated samples kept as extras
    eik_idx: torch.Tensor    # (R, 1) int64 in [0, total_fg_samples): one
    #                          sample depth per ray for the eikonal points
    bg: torch.Tensor | None = None  # (R, N_samples_inverse_sphere) U[0, 1):
    #                          the background depths' jitter (with
    #                          `inverse_sphere_bg`)

    @classmethod
    def sample(cls, cfg: "SamplerConfig", n_rays: int,
               gen: torch.Generator) -> "SamplerDraws":
        dev = gen.device
        total = sum(cfg.eval_counts)
        perm = torch.randperm(total, generator=gen, device=dev)
        return cls(
            strat=torch.rand((n_rays, cfg.eval_counts[0]), generator=gen,
                             device=dev),
            final=torch.rand((n_rays, cfg.N_samples + 1), generator=gen,
                             device=dev),
            extra_idx=torch.sort(perm[:cfg.N_samples_extra]).values,
            eik_idx=torch.randint(0, cfg.total_fg_samples, (n_rays, 1),
                                  generator=gen, device=dev),
            bg=(torch.rand((n_rays, cfg.N_samples_inverse_sphere),
                           generator=gen, device=dev)
                if cfg.inverse_sphere_bg else None))


def sorted_uniform(u: torch.Tensor) -> torch.Tensor:
    """(R, n + 1) U[0, 1) -> (R, n) sorted U(0, 1) draws: normalized
    partial sums of n + 1 Exp(1) spacings have the joint law of n sorted
    uniforms (`i2sdf_tpu/models/sampler.py:188-196`)."""
    s = torch.cumsum(-torch.log1p(-u), dim=-1)
    return s[:, :-1] / torch.clamp(s[:, -1:], min=1e-12)


def far_depths(cfg: SamplerConfig, ray_dirs: torch.Tensor,
               cam_loc: torch.Tensor) -> torch.Tensor:
    """(R, 1) far end of each ray: the scene sphere's far intersection with
    the NeRF++ background, else twice the sphere's radius."""
    if cfg.inverse_sphere_bg:
        inter, _ = get_sphere_intersections(cam_loc, ray_dirs,
                                            r=cfg.scene_bounding_sphere)
        return inter[:, 1:]
    return torch.full((ray_dirs.shape[0], 1), cfg.far, dtype=torch.float32,
                      device=ray_dirs.device)


def uniform_z_vals(cfg: SamplerConfig, ray_dirs: torch.Tensor,
                   cam_loc: torch.Tensor, n: int) -> torch.Tensor:
    """Deterministic init: n depths evenly spaced on [near, far]."""
    far = far_depths(cfg, ray_dirs, cam_loc)
    return linear_z_vals(torch.full_like(far, cfg.near), far, n)


def _d_star(z_vals: torch.Tensor, sdf: torch.Tensor):
    """Theorem-1 triangle bound on the in-section distance to the surface."""
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    a, b, c = dists, sdf[:, :-1].abs(), sdf[:, 1:].abs()
    first_cond = a ** 2 + b ** 2 <= c ** 2
    second_cond = a ** 2 + c ** 2 <= b ** 2
    s = (a + b + c) / 2.0
    area = s * (s - a) * (s - b) * (s - c)
    mask = (~first_cond) & (~second_cond) & (b + c - a > 0)
    first_only = first_cond & (~second_cond)
    heron = torch.nan_to_num(2.0 * torch.sqrt(torch.clamp(area, min=0.0))
                             / torch.clamp(a, min=1e-12))
    d_star = first_only * b + second_cond * c + heron * mask
    same_sign = torch.sign(sdf[:, 1:]) * torch.sign(sdf[:, :-1]) == 1
    return same_sign * d_star, dists


def _error_bound(beta, sdf, dists, d_star):
    """Per-ray max opacity-error bound; beta: (R, 1) or scalar."""
    density = laplace_density(sdf, beta)
    shifted = torch.cat([torch.zeros_like(dists[:, :1]),
                         dists * density[:, :-1]], dim=-1)
    integral = prefix_sum(shifted)
    err = torch.exp(-d_star / beta) * dists ** 2 / (4 * beta ** 2)
    bound = ((torch.clamp(torch.exp(prefix_sum(err)), max=1e6) - 1.0)
             * torch.exp(-integral[:, :-1]))
    return bound.max(dim=-1).values


def converged_rays(cfg: SamplerConfig, z_vals, sdf, beta0) -> torch.Tensor:
    """(R,) bool: is the ray's error bound at beta0 at most eps (the plain
    version of the convergence-check kernel; JAX `sampler.py:447-462`)."""
    d_star, dists = _d_star(z_vals, sdf)
    return _error_bound(beta0, sdf, dists, d_star) <= cfg.eps


def round_update(cfg: SamplerConfig, z_vals, sdf, beta, beta0, u,
                 final: bool):
    """One refinement round (plain version of the sampler-round kernel).

    z_vals/sdf: (R, S) sorted; beta: (R,); beta0: 0-d tensor; u: (R, N).
    Returns (samples (R, N), beta (R,))."""
    R = z_vals.shape[0]
    d_star, dists = _d_star(z_vals, sdf)
    converged = _error_bound(beta0, sdf, dists, d_star) <= cfg.eps
    beta = torch.where(converged, beta0, beta)
    lo = beta0.expand(R)
    hi = beta
    for _ in range(cfg.beta_iters):
        mid = 0.5 * (lo + hi)
        ok = _error_bound(mid[:, None], sdf, dists, d_star) <= cfg.eps
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid)
    beta = hi

    density = laplace_density(sdf, beta[:, None])
    dists_inf = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], -1)
    free_energy = dists_inf * density
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]),
                         free_energy[:, :-1]], dim=-1)
    transmittance = torch.exp(-prefix_sum(shifted))
    weights = (1.0 - torch.exp(-free_energy)) * transmittance
    if final:
        pdf = weights[:, :-1] + 1e-5
    else:
        err = (torch.exp(-d_star / beta[:, None]) * dists ** 2
               / (4 * beta[:, None] ** 2))
        pdf = ((torch.clamp(torch.exp(prefix_sum(err)), max=1e6) - 1.0)
               * transmittance[:, :-1] + cfg.add_tiny)
    return sample_cdf(z_vals, pdf_to_cdf(pdf), u), beta


RoundImpl = Callable[..., tuple]
ConvImpl = Callable[..., torch.Tensor]
SdfFn = Callable[[torch.Tensor], torch.Tensor]


def _sorted_merge(z_a, pay_a, z_b, pay_b):
    """Row-wise merge of two sample sets with their payloads (stable:
    ties keep `a` before `b`, as the reference's stable key sort does)."""
    z, order = torch.sort(torch.cat([z_a, z_b], dim=-1), dim=-1, stable=True)
    if pay_a is None:
        return z, None
    return z, torch.gather(torch.cat([pay_a, pay_b], dim=-1), -1, order)


def error_bound_z_vals(cfg: SamplerConfig, sdf_fn: SdfFn, ray_dirs, cam_loc,
                       beta0, round_impl: RoundImpl | None = None,
                       draws: SamplerDraws | None = None,
                       conv_impl: ConvImpl | None = None):
    """Adaptive sampling: (z (R, total_fg_samples) sorted, z_bg (R,
    N_samples_inverse_sphere) or None).

    ray_dirs (R, 3) unit, cam_loc (R, 3), beta0 0-d tensor. `sdf_fn` maps
    (N, 3) -> (N,); `round_impl` has `round_update`'s signature minus cfg;
    `conv_impl` maps (z, sdf, beta0) -> (R,) bool (`converged_rays`
    without cfg). With `draws` the init is stratified, the final round
    takes sorted uniforms, the extras are the drawn subset and the
    background depths are jittered (training); without, all are
    deterministic (eval). `z_bg` are the NeRF++ background's inverse
    depths in [0, 1 / sphere], ascending (None without
    `inverse_sphere_bg`).

    The reference's `lax.cond` on global convergence is a Python branch on
    `bool(converged)` here: one host sync per refinement round (on the
    global and per-ray branches; none with `early_exit: false`), which
    decides whether the next round runs the SDF MLP and the round kernel
    at all."""
    R = ray_dirs.shape[0]
    device = ray_dirs.device
    beta0 = torch.as_tensor(beta0, dtype=torch.float32, device=device)
    counts = cfg.eval_counts
    impl = round_impl or (lambda *a: round_update(cfg, *a))

    def linspace_u(rows, n):
        return torch.linspace(0.0, 1.0, n, dtype=torch.float32,
                              device=device).expand(rows, n)

    def eval_sdf(z, rows=None):
        c, d = (cam_loc, ray_dirs) if rows is None else (cam_loc[rows],
                                                         ray_dirs[rows])
        pts = c[:, None, :] + z[..., None] * d[:, None, :]
        return sdf_fn(pts.reshape(-1, 3)).reshape(z.shape)

    z_vals = uniform_z_vals(cfg, ray_dirs, cam_loc, counts[0])
    if draws is not None:
        z_vals = stratify(z_vals, draws.strat)
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    beta = torch.sqrt((1.0 / (4.0 * math.log(cfg.eps + 1.0)))
                      * (dists ** 2).sum(-1))
    final_u = (linspace_u(R, cfg.N_samples) if draws is None
               else sorted_uniform(draws.final).contiguous())

    sdf = eval_sdf(z_vals)
    if cfg.early_exit and not cfg.per_ray_exit:
        samples = None
        converged = False
        for it in range(cfg.max_total_iters):
            if samples is not None:
                n_new = samples.shape[1]
                # once every ray converged, the emitted samples are copies
                # of the leading columns, so their SDF is too: the MLP is
                # skipped
                new_sdf = sdf[:, :n_new] if converged else eval_sdf(samples)
                z_vals, sdf = _sorted_merge(z_vals, sdf, samples, new_sdf)
            if it == cfg.max_total_iters - 1:
                final_samples, beta = impl(z_vals, sdf, beta, beta0, final_u,
                                           True)
                break
            n_next = counts[it + 1]
            if not converged:
                samples, beta = impl(z_vals, sdf, beta, beta0,
                                     linspace_u(R, n_next), False)
                converged = bool((beta <= beta0).all())  # host sync
            if converged:
                samples = z_vals[:, :n_next]
    else:
        conv = conv_impl or (lambda *a: converged_rays(cfg, *a))
        z_vals, final_samples = _rounds_per_ray(
            cfg, impl, conv, eval_sdf, linspace_u, z_vals, sdf, beta, beta0,
            final_u)

    near = torch.full((R, 1), cfg.near, dtype=torch.float32, device=device)
    far = far_depths(cfg, ray_dirs, cam_loc)
    if cfg.N_samples_extra > 0:
        idx = (extra_sample_index(z_vals.shape[1], cfg.N_samples_extra)
               if draws is None else draws.extra_idx)
        z_extra = torch.cat([near, z_vals[:, idx.to(device)], far], dim=-1)
    else:
        z_extra = torch.cat([near, far], dim=-1)
    z_final = _sorted_merge(final_samples, None, z_extra, None)[0]

    z_bg = None
    if cfg.inverse_sphere_bg:
        # uniform in inverse depth on [0, 1], scaled by 1 / sphere
        z_bg = linspace_u(R, cfg.N_samples_inverse_sphere)
        if draws is not None:
            z_bg = stratify(z_bg, draws.bg)
        z_bg = z_bg * (1.0 / cfg.scene_bounding_sphere)
    return z_final, z_bg


def per_ray_caps(cfg: SamplerConfig, n_rays: int) -> list:
    """Rays refined at rounds 1 .. max_total_iters - 1: caps[i] =
    ceil(fracs[i] * R), all R for a fraction >= 1 (`sampler.py:331-340`)."""
    fracs = (tuple(cfg.per_ray_fracs) if cfg.per_ray_fracs
             else DEFAULT_PER_RAY_FRACS)
    caps = []
    for it in range(cfg.max_total_iters - 1):
        f = fracs[min(it, len(fracs) - 1)]
        caps.append(n_rays if f >= 1.0
                    else max(1, int(math.ceil(f * n_rays))))
    return caps


def _widen(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each row with n copies of its last column appended (sorted rows stay
    sorted; the new sections are zero-wide)."""
    return torch.cat([x, x[:, -1:].expand(x.shape[0], n)], dim=-1)


def _rounds_per_ray(cfg: SamplerConfig, impl, conv, eval_sdf, linspace_u,
                    z_vals, sdf, beta, beta0, final_u):
    """The refinement rounds with per-ray compaction
    (`per_ray_exit and early_exit`, `sampler.py:331-491`), or with
    `early_exit: false` every round on every ray. Returns (the accumulated
    z (R, sum(eval_counts)), the final round's samples)."""
    R = z_vals.shape[0]
    device = z_vals.device
    per_ray = cfg.per_ray_exit and cfg.early_exit
    caps = per_ray_caps(cfg, R)
    counts = cfg.eval_counts
    conv_ray = torch.zeros(R, dtype=torch.bool, device=device)
    converged = False  # round 0 always runs
    samples = sel = s_sel = z_sel = None
    for it in range(cfg.max_total_iters):
        if samples is not None:
            n_new = samples.shape[1]
            if sel is not None:
                # compacted round: `samples` (cap, n_new) belong to rows
                # `sel`; after global convergence they are leading-column
                # copies and so is their SDF
                zg, sg = z_vals[sel], sdf[sel]
                new_sdf = sg[:, :n_new] if converged else eval_sdf(samples,
                                                                   sel)
                z_sel, s_sel = _sorted_merge(zg, sg, samples, new_sdf)
                z_vals = _widen(z_vals, n_new).index_copy_(0, sel, z_sel)
                sdf = _widen(sdf, n_new).index_copy_(0, sel, s_sel)
            else:
                new_sdf = sdf[:, :n_new] if converged else eval_sdf(samples)
                z_vals, sdf = _sorted_merge(z_vals, sdf, samples, new_sdf)
                z_sel = s_sel = None
        if it == cfg.max_total_iters - 1:
            return z_vals, impl(z_vals, sdf, beta, beta0, final_u, True)[0]
        n_next = counts[it + 1]
        if cfg.early_exit:
            # only refined rows can change their convergence
            if s_sel is not None:
                conv_ray = conv_ray.index_copy(0, sel,
                                               conv(z_sel, s_sel, beta0))
            else:
                conv_ray = conv(z_vals, sdf, beta0)
            converged = bool(conv_ray.all())  # host sync
        cap = caps[it]
        if per_ray and cap < R:
            # unconverged rays first; ties broken by a per-round rotated
            # index, so an overflow is spread over the rays round by round
            rot = (torch.arange(R, device=device) + it * cap) % R
            sel = torch.argsort(conv_ray.long() * R + rot)[:cap]
            zg, sg, bg = z_vals[sel], sdf[sel], beta[sel]
            if converged:
                samples = zg[:, :n_next]
            else:
                samples, bg = impl(zg.contiguous(), sg.contiguous(), bg,
                                   beta0, linspace_u(cap, n_next), False)
                beta = beta.index_copy(0, sel, bg)
        else:
            sel = None
            if converged:
                samples = z_vals[:, :n_next]
            else:
                samples, beta = impl(z_vals, sdf, beta, beta0,
                                     linspace_u(R, n_next), False)


def extra_sample_index(n: int, k: int) -> torch.Tensor:
    """Eval's evenly spaced subset of the accumulated samples:
    `linspace(0, n-1, k)` in f32, truncated to int (the reference's
    `jnp.linspace(...).astype(int32)`)."""
    return torch.linspace(0, n - 1, k, dtype=torch.float32).to(torch.int64)
