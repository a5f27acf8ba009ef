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

_MAX_WIDTH = 256  # a 64-row tile of four 64-column chunks
_PASS_ROWS = 128  # a pass's columns: kPassRows in csrc/sdf_mlp.cu
_PLAIN_CHUNK = 1 << 18


def stage_chain(net: mlp.ImplicitNet) -> mma_pack.PackedMlp:
    """The implicit net as K1's stage images, the output layer cut to the
    sdf column (an N = 8 product)."""
    mma_pack.check_sdf_net(net.cfg)
    k = mma_pack.pack_stage_chain(mma_pack.sdf_chain(net, last_cols=[0]),
                                  rows=_PASS_ROWS)
    if k.max_width > _MAX_WIDTH:
        raise ValueError(f"sdf_mlp_nograd: layer width above {_MAX_WIDTH}")
    return k


class SdfMlpPack:
    """The implicit net, plus its kernel layout when it lives on the card."""

    def __init__(self, net: mlp.ImplicitNet):
        self.net = net
        self.kernel = None
        if next(net.parameters()).is_cuda:
            self.kernel = stage_chain(net)


def sdf_mlp_plain(net: mlp.ImplicitNet, points: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) clamped SDF in f32 (chunked to bound memory: each
    chunk's sdf column is copied out of the net's output, whose features
    would otherwise stay alive with it)."""
    chunks = [mlp.sdf_vals(net, c)[:, 0].contiguous()
              for c in points.split(_PLAIN_CHUNK)]
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
        p.net.cfg.multires, mma_pack.stream_of(points))
    build.check(err, "sdf_mlp_nograd")
    launches += 1
    cfg = p.net.cfg
    if cfg.sdf_bounding_sphere > 0.0:
        out = mlp.clamp_sdf(cfg, out[:, None], points)[:, 0]
    return out
