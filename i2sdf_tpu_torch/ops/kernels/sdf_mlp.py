"""K1 `sdf_mlp_nograd`: the sampler's no-grad SDF evaluator.

Replaces `i2sdf_tpu/ops/pallas/fused_mlp.py:157 fused_sdf_mlp`. The CUDA
kernel is `csrc/sdf_mlp.cu` (its header says what bounds it and how it is
built); `sdf_mlp_plain` is the same function in plain PyTorch (f32), which
the CPU path and the tests use.
"""

from __future__ import annotations

import torch

from ...models import mlp
from . import build, mma_pack

launches = 0  # kernel launches since the last reset_launch_counts()

_MAX_WIDTH = 256  # 8 warps x 4 tiles x 8 columns
_PLAIN_CHUNK = 1 << 18


class SdfMlpPack:
    """The implicit net, plus its kernel layout when it lives on the card."""

    def __init__(self, net: mlp.ImplicitNet):
        self.net = net
        self.kernel = None
        if next(net.parameters()).is_cuda:
            cfg = net.cfg
            mma_pack.check_sdf_net(cfg)
            # the output layer is cut to the sdf column
            self.kernel = mma_pack.pack_chain(
                mma_pack.sdf_chain(net, last_cols=[0]))
            if self.kernel.max_width > _MAX_WIDTH:
                raise ValueError(f"sdf_mlp_nograd: layer width above "
                                 f"{_MAX_WIDTH}")
            self.lda = mma_pack.row_stride(self.kernel.max_width)


def sdf_mlp_plain(net: mlp.ImplicitNet, points: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) clamped SDF in f32 (chunked to bound memory)."""
    chunks = [mlp.sdf_vals(net, c)[:, 0] for c in points.split(_PLAIN_CHUNK)]
    return torch.cat(chunks) if chunks else points.new_zeros((0,))


def sdf_mlp_nograd(p: SdfMlpPack, points: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) clamped SDF. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    global launches
    if not points.is_cuda:
        return sdf_mlp_plain(p.net, points)
    if p.kernel is None:
        raise ValueError("sdf_mlp_nograd: the net's weights are not on the "
                         "card")
    mma_pack.check_input(points, "points", cols=3)
    n = points.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    k = p.kernel
    lib = build.load_library()
    err = lib.i2sdf_sdf_mlp_nograd(
        points.data_ptr(), out.data_ptr(), n, k.weights.data_ptr(),
        k.biases.data_ptr(), k.plan.ctypes.data, k.n_layers,
        p.net.cfg.multires, p.lda, mma_pack.stream_of(points))
    build.check(err, "sdf_mlp_nograd")
    launches += 1
    cfg = p.net.cfg
    if cfg.sdf_bounding_sphere > 0.0:
        out = mlp.clamp_sdf(cfg, out[:, None], points)[:, 0]
    return out
