"""Input encodings (counterpart of `i2sdf_tpu/models/embedder.py`): the NeRF
positional encoding, real spherical harmonics and random Fourier features.

Positional encoding keeps the reference's wide-block layout `[x | sin
block | cos block]`, each block dim-major: `sin(x*f0..fK), sin(y*f0..fK),
sin(z*f0..fK)`. Keeping the JAX package's layout means first-layer
weights cross between the packages with no row permutation. The CUDA
kernels build the same layout in-kernel (`csrc/common.cuh::pe_value`).

Spherical harmonics (degrees 1-5, `degree ** 2` columns) take the JAX
package's constants. Fourier features take their (d, channels) matrix `B`
as a tensor: the JAX package draws it from a JAX key, which the port
cannot reproduce, so a caller passes the same matrix to both.
"""

from __future__ import annotations

import math

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


# real SH coefficients, degrees 0..4 (JAX `embedder.py:83-93`)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396]
_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435]
_C4 = [2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761]


def sh_dim(degree: int) -> int:
    return degree ** 2


def spherical_harmonics(p: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """(..., 3) -> (..., degree ** 2): the real SH basis up to `degree` (1
    to 5), in the JAX package's column order."""
    if p.shape[-1] != 3 or not 1 <= degree <= 5:
        raise ValueError("spherical_harmonics: needs 3-d inputs and a "
                         "degree from 1 to 5")
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    res = [torch.full_like(x, _C0)]
    if degree > 1:
        res += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        res += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree > 3:
        res += [_C3[0] * y * (3 * xx - yy), _C3[1] * xy * z,
                _C3[2] * y * (4 * zz - xx - yy),
                _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3 * yy)]
    if degree > 4:
        res += [_C4[0] * xy * (xx - yy), _C4[1] * yz * (3 * xx - yy),
                _C4[2] * xy * (7 * zz - 1), _C4[3] * yz * (7 * zz - 3),
                _C4[4] * (zz * (35 * zz - 30) + 3),
                _C4[5] * xz * (7 * zz - 3), _C4[6] * (xx - yy) * (7 * zz - 1),
                _C4[7] * xz * (xx - 3 * yy),
                _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(res, dim=-1)


def fourier_feature(x: torch.Tensor, B: torch.Tensor,
                    include_input: bool = True) -> torch.Tensor:
    """(..., d) -> (..., [d +] 2 * channels): [x | sin(2 pi x B) | cos(2 pi
    x B)] for a (d, channels) matrix B (the JAX package's
    `N(0, sigma^2)` draw, passed in)."""
    xp = (2 * math.pi * x) @ B.to(x)
    parts = [x] if include_input else []
    return torch.cat(parts + [torch.sin(xp), torch.cos(xp)], dim=-1)


def get_embedder(embed_type: str = "positional", **kwargs):
    """(embed_fn, out_dim) for an encoding, dispatched as the JAX
    `get_embedder` does: `multires` for positional, `degree` (default 4;
    `multires` ignored) for spherical harmonics, the matrix `B` for
    Fourier."""
    d = kwargs.get("input_dims", 3)
    if embed_type == "positional":
        m = kwargs["multires"]
        return (lambda x: positional_encoding(x, m)), pe_dim(m, d)
    if embed_type == "spherical_harmonics":
        if d != 3:
            raise ValueError("spherical_harmonics: needs 3-d inputs")
        deg = kwargs.get("degree", 4)
        return (lambda x: spherical_harmonics(x, deg)), sh_dim(deg)
    if embed_type == "fourier":
        if "B" not in kwargs:
            raise ValueError("fourier: the port takes the (d, channels) "
                             "matrix B as a tensor (the JAX package draws it "
                             "from a JAX key)")
        B, inc = kwargs["B"], kwargs.get("include_input", True)
        return ((lambda x: fourier_feature(x, B, inc)),
                2 * B.shape[1] + (d if inc else 0))
    raise ValueError(f"Unknown embedding type: {embed_type}")
