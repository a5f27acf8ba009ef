"""K7 `conv_check`: the per-ray sampler's convergence flags.

Replaces `i2sdf_tpu/ops/pallas/sampler_round.py:355 conv_check_pallas`.
The CUDA kernel is `csrc/conv_check.cu` (its header says what bounds it);
the plain version is `i2sdf_tpu_torch.models.sampler.converged_rays`
(f32 scans), which the CPU path and the tests use.
"""

from __future__ import annotations

import torch

from ...models.sampler import SamplerConfig, converged_rays
from . import build, mma_pack

launches = 0  # kernel launches since the last reset_launch_counts()

MAX_SAMPLES = 1024  # 32 lanes x 32 samples in registers, as K2


def conv_check(cfg: SamplerConfig, z_vals: torch.Tensor, sdf: torch.Tensor,
               beta0: torch.Tensor) -> torch.Tensor:
    """(R,) bool for sorted z_vals/sdf (R, S) and beta0 a 0-d tensor: is
    the ray's error bound at beta0 at most cfg.eps. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    global launches
    if not z_vals.is_cuda:
        return converged_rays(cfg, z_vals, sdf, beta0)
    R, S = z_vals.shape
    if not 2 <= S <= MAX_SAMPLES:
        raise ValueError(f"conv_check: {S} samples per ray, the kernel "
                         f"takes 2..{MAX_SAMPLES}")
    z_vals, sdf = z_vals.contiguous(), sdf.contiguous()
    beta0 = beta0.reshape(1).to(torch.float32).contiguous()
    for t, name in ((z_vals, "z_vals"), (sdf, "sdf"), (beta0, "beta0")):
        mma_pack.check_input(t, name)
        if t.device != z_vals.device:
            raise ValueError(f"conv_check: {name} is on {t.device}")
    if sdf.shape != (R, S):
        raise ValueError("conv_check: z_vals and sdf differ in shape")
    conv = torch.empty(R, dtype=torch.bool, device=z_vals.device)
    lib = build.load_library()
    err = lib.i2sdf_conv_check(z_vals.data_ptr(), sdf.data_ptr(),
                               beta0.data_ptr(), cfg.eps, conv.data_ptr(), R,
                               S, mma_pack.stream_of(z_vals))
    build.check(err, "conv_check")
    launches += 1
    return conv
