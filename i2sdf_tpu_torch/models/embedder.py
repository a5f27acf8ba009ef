"""NeRF positional encoding in the reference's wide-block layout
(counterpart of `i2sdf_tpu/models/embedder.py::positional_encoding`).

Channel layout `[x | sin block | cos block]`, each block dim-major:
`sin(x*f0..fK), sin(y*f0..fK), sin(z*f0..fK)`. Keeping the JAX package's
layout means first-layer weights cross between the packages with no row
permutation. The CUDA kernels build the same layout in-kernel
(`csrc/common.cuh::pe_value`).
"""

from __future__ import annotations

import numpy as np
import torch


def pe_frequencies(multires: int) -> np.ndarray:
    """Frequencies 2^0 .. 2^(multires-1)."""
    return 2.0 ** np.linspace(0.0, multires - 1, multires)


def pe_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(..., d) -> (..., d * (1 + 2 * multires))."""
    d = x.shape[-1]
    freqs = torch.as_tensor(pe_frequencies(multires), dtype=x.dtype,
                            device=x.device)
    xf = (x[..., :, None] * freqs).reshape(*x.shape[:-1], d * multires)
    return torch.cat([x, torch.sin(xf), torch.cos(xf)], dim=-1)
