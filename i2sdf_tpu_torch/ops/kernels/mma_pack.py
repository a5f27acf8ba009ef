"""Host-side weight packing for the MLP kernels (`csrc/common.cuh`).

A layer's (K, N) weight is zero-padded to multiples of 16, rounded to bf16
and reordered into `mma.m16n8k16` B-fragment order: for 8-column tile t,
16-deep k-step kk and lane l = 4*g + i, the four values
W[16kk + 2i + {0, 1}, 8t + g] and W[16kk + 8 + 2i + {0, 1}, 8t + g] are
adjacent, so a lane fetches its fragment with one 8-byte load. A `Plan`
row per layer (8 int32) tells the kernel its padded sizes, offsets and
flags; the field order is `LayerField` in `common.cuh`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SKIP_IN = 1   # inject the scaled encoding at column `col` before the layer
SCALE = 2     # scale the epilogue by 1/sqrt(2)
NO_COL = 1 << 20


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pack_b(w: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """(k, n) f32 weight -> flat bf16 fragment stream for a (K, N) tile
    grid."""
    k, n = w.shape
    full = torch.zeros((K, N), dtype=torch.float32, device=w.device)
    full[:k, :n] = w
    frag = full.to(torch.bfloat16).reshape(K // 16, 2, 4, 2, N // 8, 8)
    # -> (tile, k-step, g, i, half, pair)
    return frag.permute(4, 0, 5, 2, 1, 3).reshape(-1).contiguous()


@dataclasses.dataclass
class PackedMlp:
    """A chain of layers in kernel layout."""
    weights: torch.Tensor   # flat bf16 fragment stream of every layer
    biases: torch.Tensor    # flat f32, each layer padded to its N
    plan: np.ndarray        # (layers, 8) int32, host memory

    @property
    def n_layers(self) -> int:
        return self.plan.shape[0]

    @property
    def max_width(self) -> int:
        return int(self.plan[:, :2].max())


def pack_chain(layers: list[dict]) -> PackedMlp:
    """layers: dicts with w (k, n) f32, b (n,) f32 or None, flags, col."""
    ws, bs, rows = [], [], []
    w_off = b_off = 0
    for lay in layers:
        k, n = lay["w"].shape
        K, N = round_up(k, 16), round_up(n, 16)
        ws.append(pack_b(lay["w"], K, N))
        b = torch.zeros(N, dtype=torch.float32, device=lay["w"].device)
        if lay.get("b") is not None:
            b[:n] = lay["b"]
        bs.append(b)
        rows.append([K, N, lay.get("real", n), w_off // 4, b_off,
                     lay.get("flags", 0), lay.get("col", 0), 0])
        w_off += ws[-1].numel()
        b_off += N
    return PackedMlp(torch.cat(ws), torch.cat(bs),
                     np.ascontiguousarray(np.asarray(rows, np.int32)))


def row_stride(width: int) -> int:
    """Shared-memory row length (bf16) >= width + 8 with a row stride of
    4 banks mod 32, so a warp's fragment loads hit 32 distinct banks."""
    return round_up(width, 16) + 8


def sdf_chain(net, last_cols=None) -> list[dict]:
    """The implicit net as kernel layers. `last_cols` selects (and orders)
    the output layer's columns."""
    cfg = net.cfg
    dims = cfg.layer_dims()
    d0 = dims[0]
    layers = []
    n = net.n_layers
    for l, lin in enumerate(net.layers()):
        w, b = lin.weight().detach().float(), lin.b.detach().float()
        if l == n - 1 and last_cols is not None:
            w, b = w[:, last_cols], b[last_cols]
        flags = (SKIP_IN if l in cfg.skip_in else 0) | (
            SCALE if l + 1 in cfg.skip_in else 0)
        col = dims[l] - d0 if l in cfg.skip_in else 0
        layers.append(dict(w=w, b=b, flags=flags, col=col))
    return layers


def check_sdf_net(cfg, embed_none: bool = False) -> None:
    """Refuse a net the SDF kernels cannot run: they take 3-d points with
    the positional encoding (or, where `embed_none`, with no encoding:
    the tangent-stream kernels K10-K12 run that as frequency count 0)."""
    if cfg.d_in != 3 or not (cfg.embed_type == "positional"
                             or (embed_none and cfg.embed_type is None)):
        raise ValueError("the SDF kernels take 3-d points with the "
                         "positional encoding")
    if 0 in cfg.skip_in:
        raise ValueError("a skip into layer 0 is not supported")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_input(t: torch.Tensor, name: str, cols: int | None = None):
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 tensor")
    if cols is not None and (t.dim() != 2 or t.shape[1] != cols):
        raise ValueError(f"{name}: expected shape (n, {cols}), got "
                         f"{tuple(t.shape)}")
