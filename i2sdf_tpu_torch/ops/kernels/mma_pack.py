"""Host-side weight packing for the MLP kernels.

A net is a chain of layers with one `Plan` row per layer (8 int32: padded
sizes, offsets, flags; the field order is `LayerField` in
`csrc/common.cuh`), its weights as stage images (`pack_stage_chain`,
every kernel on `csrc/wgmma_layer.cuh`): per 64-deep chunk of K, W^T's N
rows x 64 columns in wgmma's 128-byte-swizzle K-major layout, one
contiguous block that one bulk copy brings into shared memory. K is
padded to 16 and N to one of the kernels' instantiated widths
(`WG_WIDTHS`); `kWOff` counts bf16 elements, and `kStageRows` (field 7)
the rows of W^T a stage holds where a layer comes in passes (0: all N).
`rev.RevStages`, `sdf_outputs.OutputStages` and `bg_core.BgStages`
gather each chain from the net's flat weights through a layout built
once for its shapes (`chain_index`, `gather_chain`).
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


@dataclasses.dataclass
class PackedMlp:
    """A chain of layers in kernel layout."""
    weights: torch.Tensor   # flat bf16: every layer's stage images
    biases: torch.Tensor    # flat f32, each layer padded to its N
    plan: np.ndarray        # (layers, 8) int32, host memory

    @property
    def n_layers(self) -> int:
        return self.plan.shape[0]

    @property
    def max_width(self) -> int:
        return int(self.plan[:, :2].max())


STAGE_K = 64                          # K columns of a stage (128 bytes)
WG_WIDTHS = (8, 16, 32, 64, 128, 256)  # the wgmma widths the kernels take


def wg_width(n: int) -> int:
    """The narrowest instantiated wgmma width that holds n columns."""
    for w in WG_WIDTHS:
        if n <= w:
            return w
    raise ValueError(f"a layer of {n} columns is wider than the wgmma "
                     f"kernels' {WG_WIDTHS[-1]}")


def swizzle_groups(rows: int, device=None) -> torch.Tensor:
    """(rows, 8): the 16-byte group of a 128-byte row held at each
    position, g ^ (row % 8) (an involution: it maps both ways)."""
    r = torch.arange(rows, device=device)
    return torch.arange(8, device=device)[None, :] ^ (r[:, None] % 8)


def pack_stages(w: torch.Tensor, K: int, N: int, rows: int = 256,
                dtype=torch.bfloat16) -> torch.Tensor:
    """(k, n) f32 weight -> its stage images for a (K, N) layer, flat bf16
    (`dtype`): for each 64-deep chunk c of K (zero past K), rows r of W^T
    at r * 64 elements, 16-byte group q of columns [64 c, 64 c + 64) at
    position q ^ (r % 8). A layer of N > `rows` comes as stages of `rows`
    rows, every chunk of W^T's first `rows` rows first (the passes K1
    takes)."""
    k, n = w.shape
    Kc = round_up(K, STAGE_K)
    wt = torch.zeros((N, Kc), dtype=dtype, device=w.device)
    wt[:n, :k] = w.t()
    R = min(N, rows)
    t = wt.reshape(N // R, R, Kc // STAGE_K, 8, 8)
    t = t.permute(0, 2, 1, 3, 4)           # (pass, chunk, row, group, elt)
    r = torch.arange(R, device=w.device)[:, None]
    img = t[:, :, r, swizzle_groups(R, w.device)]
    return img.reshape(-1).contiguous()


def pack_stage_chain(layers: list[dict], rows: int = 256,
                     dtype=torch.bfloat16) -> PackedMlp:
    """Layers (dicts of w (k, n) f32, b (n,) f32 or None, flags, col,
    real) as stage
    images of at most `rows` rows
    (`pack_stages`, recorded as the plan's kStageRows when below N):
    K = round_up(k, 16), N = wg_width(n), biases zero-padded to N. With
    an integer `dtype` the layers hold positions and the chain is their
    layout (`gather_chain`)."""
    bdtype = torch.float32 if dtype.is_floating_point else dtype
    ws, bs, plan = [], [], []
    w_off = b_off = 0
    for lay in layers:
        k, n = lay["w"].shape
        K, N = round_up(k, 16), wg_width(n)
        R = min(N, rows)
        ws.append(pack_stages(lay["w"], K, N, R, dtype))
        b = torch.zeros(N, dtype=bdtype, device=lay["w"].device)
        if lay.get("b") is not None:
            b[:len(lay["b"])] = lay["b"]
        bs.append(b)
        plan.append([K, N, lay.get("real", n), w_off, b_off,
                     lay.get("flags", 0), lay.get("col", 0),
                     R if R < N else 0])
        w_off += ws[-1].numel()
        b_off += N
    return PackedMlp(torch.cat(ws), torch.cat(bs),
                     np.ascontiguousarray(np.asarray(plan, np.int32)))


def gather_chain(index: PackedMlp, w_src: torch.Tensor,
                 b_src: torch.Tensor) -> PackedMlp:
    """The chain whose layout `index` holds (`pack_stage_chain` of int64
    positions, 0 for zero and p for element p of the sources), packed from
    flat f32 weights and biases (`w_src`, `b_src`, a zero first) in two
    gathers: the same bits as `pack_stage_chain` of the weights."""
    return PackedMlp(w_src[index.weights].to(torch.bfloat16),
                     b_src[index.biases], index.plan)


def flat_sources(ws, bs) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat f32 weights and biases `gather_chain` reads (a zero
    first, then each leaf's elements in order), on the leaves' device."""
    zero = torch.zeros(1, dtype=torch.float32, device=ws[0].device)
    return tuple(torch.cat([zero] + [t.detach().reshape(-1).float()
                                     for t in ts]) for ts in (ws, bs))


class ChainIndex:
    """The layout of stage chains built once for one set of (in, out)
    weight shapes (`chain_index` keeps one a key): `chains(ws, bs)` makes
    the chains' layers from position tensors (`ws[i]` of `shapes[i]`,
    `bs[i]` of its output width, numbered as `flat_sources` lays the
    leaves out), each packed as int64 positions in stages of at most
    `rows[i]` rows (`pack_stage_chain`); `host` holds them, and `on`
    moves them once to each device it is asked for."""

    def __init__(self, chains, shapes: tuple, rows: tuple):
        def positions(shapes):
            out, first = [], 1
            for shape in shapes:
                n = int(np.prod(shape))
                out.append(torch.arange(first, first + n).view(shape))
                first += n
            return out

        layers = chains(positions(shapes),
                        positions([(m,) for _, m in shapes]))
        self.host = [pack_stage_chain(c, rows=r, dtype=torch.int64)
                     for c, r in zip(layers, rows)]
        self._on = {}

    def on(self, device) -> list[PackedMlp]:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = [PackedMlp(c.weights.to(device),
                                          c.biases.to(device), c.plan)
                                for c in self.host]
        return self._on[device]


_INDEX: dict = {}


def chain_index(key, chains, shapes: tuple, rows: tuple) -> ChainIndex:
    """The `ChainIndex` kept under `key` (the pack's name, the nets'
    configs and `shapes`), built at its first use."""
    if key not in _INDEX:
        _INDEX[key] = ChainIndex(chains, shapes, rows)
    return _INDEX[key]


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
