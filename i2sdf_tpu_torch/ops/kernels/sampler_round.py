"""K2 `sampler_round`: one refinement round of the error-bounded sampler.

Replaces `i2sdf_tpu/ops/pallas/sampler_round.py:218 sampler_round_pallas`.
The CUDA kernel is `csrc/sampler_round.cu` (its header says what bounds it
and how it is built); the plain version is
`i2sdf_tpu_torch.models.sampler.round_update` (f32), which the CPU path
and the tests use.
"""

from __future__ import annotations

import torch

from ...models.sampler import SamplerConfig, round_update
from . import build, mma_pack

launches = 0  # kernel launches since the last reset_launch_counts()

MAX_SAMPLES = 1024  # 32 lanes x 32 samples in registers


def sampler_round_plain(cfg: SamplerConfig, z_vals, sdf, beta, beta0, u,
                        final: bool):
    return round_update(cfg, z_vals, sdf, beta, beta0, u, final)


def sampler_round(cfg: SamplerConfig, z_vals: torch.Tensor, sdf: torch.Tensor,
                  beta: torch.Tensor, beta0: torch.Tensor, u: torch.Tensor,
                  final: bool):
    """(samples (R, N), beta (R,)) for sorted z_vals/sdf (R, S), beta (R,),
    beta0 a 0-d tensor and u (R, N) in [0, 1]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    global launches
    if not z_vals.is_cuda:
        return sampler_round_plain(cfg, z_vals, sdf, beta, beta0, u, final)
    R, S = z_vals.shape
    if not 2 <= S <= MAX_SAMPLES:
        raise ValueError(f"sampler_round: {S} samples per ray, the kernel "
                         f"takes 2..{MAX_SAMPLES}")
    z_vals, sdf, u = (t.contiguous() for t in (z_vals, sdf, u))
    beta = beta.contiguous()
    beta0 = beta0.reshape(1).to(torch.float32).contiguous()
    for t, name in ((z_vals, "z_vals"), (sdf, "sdf"), (beta, "beta"),
                    (u, "u"), (beta0, "beta0")):
        mma_pack.check_input(t, name)
        if t.device != z_vals.device:
            raise ValueError(f"sampler_round: {name} is on {t.device}")
    if sdf.shape != (R, S) or beta.shape != (R,) or u.shape[0] != R:
        raise ValueError("sampler_round: inconsistent shapes")
    n_out = u.shape[1]
    samples = torch.empty((R, n_out), dtype=torch.float32,
                          device=z_vals.device)
    beta_out = torch.empty(R, dtype=torch.float32, device=z_vals.device)
    lib = build.load_library()
    err = lib.i2sdf_sampler_round(
        z_vals.data_ptr(), sdf.data_ptr(), beta.data_ptr(), u.data_ptr(),
        samples.data_ptr(), beta_out.data_ptr(), R, S, n_out,
        beta0.data_ptr(), cfg.beta_iters, cfg.eps, cfg.add_tiny,
        int(final), mma_pack.stream_of(z_vals))
    build.check(err, "sampler_round")
    launches += 1
    return samples, beta_out
