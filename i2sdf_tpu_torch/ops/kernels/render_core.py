"""K3 `render_core_fwd` and K4 `render_core_bwd`: SDF, spatial gradient and
radiance at points (and, with a light head, the light mask), and the
backward of the same function.

Replaces `i2sdf_tpu/ops/pallas/fused_train.py:449 get_render_core_op`:
its forward (pallas_call at `:555`) is K3 (`csrc/render_core.cu`), its
backward (`:609`, `_make_bwd_kernel` at `:267-446`) is K4
(`csrc/render_core_bwd.cu`). Each CUDA source's header says what bounds
it and how it is built.

The light head of the light-mask config (the `lcfg` / `detach_light`
branch of the TPU op: `_light_forward` at `:173-195`, the forward at
`:252-256`, the backward at `:324-348`) runs inside both kernels: the
light MLP on relu(features), a sigmoid mask (N, 1) beside sdf, grad and
rgb. K3 and K4 with the light head are their own kernel instantiations
(`kLight` in `csrc/common.cuh`), counted apart: `render_core_fwd_light`
and `render_core_bwd_light`. The light loss reaches the light net; with
`detach_light` off, its feature cotangent joins the SDF's through
relu'(features) (`fused_train.py:345-348`).

* `render_core_fwd(pack, x, dirs)`: the eval forward (no gradient).
* `render_core_train(nets, x, dirs)`: the training op, differentiable
  with respect to every net's parameters, through the spatial gradient
  too. On the card it is `RenderCoreTrain`, a `torch.autograd.Function`
  whose forward launches K3 and whose backward launches K4; it takes the
  *materialized* weights (weight norm applied outside by autograd) and
  saves only its inputs, as `op_fwd` does (`fused_train.py:647-650`).
* `render_core_plain` / `render_core_train_plain`: the same functions in
  plain f32 PyTorch (the gradient by autograd, with `create_graph` for
  training; the light head as `_ref_light` in
  `tests/test_pallas_train.py:139-148`). The CPU path and the tests use
  them; on the card they only serve as the yardstick the kernels are
  held to.

The bounding-sphere clamp is applied outside the kernels, as
`fused_train.py:771-777` does. The SDF net's kernel layout (`sdf_chains`),
the backward's scratch plan (`_BwdPlan`) and its shared-memory size
(`bwd_smem`) serve K5 and K6 too (`rev.py`), whose kernels are K3's and
K4's kernel bodies without the radiance net (`csrc/common.cuh`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...models import mlp
from . import build, mma_pack

launches = 0      # K3 launches since the last reset_launch_counts()
bwd_launches = 0  # K4 launches since the last reset_launch_counts()
light_launches = 0      # K3 with the light head
light_bwd_launches = 0  # K4 with the light head

_ROWS = 32               # points per block (kRows in both kernels)
_MAX_WIDTH = 320         # 8 warps x 5 tiles x 8 columns
_MAX_SMEM = 232448       # bytes a block may use on the H100
_MAX_SDF, _MAX_RAD, _MAX_LIGHT = 12, 8, 4   # layer slots of K4's table
_MAX_SPLITS = 32         # point-range splits of K4's weight-gradient sums
_PLAIN_CHUNK = 1 << 17


@dataclasses.dataclass(frozen=True)
class CoreWeights:
    """Materialized (in, out) weights and biases of the nets, in the nets'
    own layouts (what autograd differentiates); the light net's are empty
    without a light head."""
    ws_sdf: tuple
    bs_sdf: tuple
    ws_rad: tuple
    bs_rad: tuple
    ws_l: tuple = ()
    bs_l: tuple = ()

    @classmethod
    def of(cls, implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet,
           light: mlp.ImplicitNet | None = None) -> "CoreWeights":
        si, ri = implicit.layers(), rendering.layers()
        li = light.layers() if light is not None else []
        return cls(tuple(l.weight() for l in si), tuple(l.b for l in si),
                   tuple(l.weight() for l in ri), tuple(l.b for l in ri),
                   tuple(l.weight() for l in li), tuple(l.b for l in li))

    def flat(self) -> list:
        return [*self.ws_sdf, *self.bs_sdf, *self.ws_rad, *self.bs_rad,
                *self.ws_l, *self.bs_l]

    @classmethod
    def unflat(cls, ts, n_sdf: int, n_rad: int,
               n_l: int = 0) -> "CoreWeights":
        ts = list(ts)
        a, b = n_sdf, 2 * n_sdf
        c = b + 2 * n_rad
        return cls(tuple(ts[:a]), tuple(ts[a:b]), tuple(ts[b:b + n_rad]),
                   tuple(ts[b + n_rad:c]), tuple(ts[c:c + n_l]),
                   tuple(ts[c + n_l:c + 2 * n_l]))


def n_layers(cfg) -> int:
    """The layer count of a net's config (0 for no net)."""
    return 0 if cfg is None else len(cfg.layer_dims()) - 1


def check_light_net(icfg: mlp.ImplicitNetConfig,
                    lcfg: mlp.ImplicitNetConfig) -> None:
    """The light heads the kernels run (`supports_render_core`,
    `fused_train.py:683-704`): no encoding, no skip, relu(features) in,
    one sigmoid output."""
    if (lcfg.embed_type is not None or lcfg.skip_in
            or lcfg.d_in != icfg.feature_vector_size or lcfg.d_out != 1
            or lcfg.feature_vector_size != 0
            or lcfg.output_activation != "sigmoid"):
        raise ValueError("render_core: the light head must be an MLP on the "
                         "features with no encoding or skip and one sigmoid "
                         "output")


def _sdf_perm(F: int) -> list:
    """Kernel column order of the SDF output layer: [features | sdf]."""
    return list(range(1, F + 1)) + [0]


def _rad_perm(vdim: int, F: int) -> list:
    """Kernel row order of the radiance input layer: [features | PE(view)]
    (the nets' order is [PE(view) | features])."""
    return list(range(vdim, vdim + F)) + list(range(vdim))


def sdf_chains(icfg: mlp.ImplicitNetConfig, ws: list, bs: list,
               perm: list | None = None, embed_none: bool = False):
    """The SDF net in the sweep kernels' layouts (K3-K6), from materialized
    (detached, f32) weights and biases, the output layer's columns in the
    order `perm` (the net's own order if None):

    * `fwd`: the chain, layer 0 first;
    * `sdft`: the chain transposed, last layer first (K3/K5's reverse
      sweep takes its rows 1.., K4/K6's downward sweep rows 0..n-2);
    * `rev`: `sdft`'s rows 1.. (the plan rows hold absolute offsets into
      the same weight stream);
    * `wsdf_col`: the output layer's sdf column in bf16, zero-padded to
      the depth of the first transposed hidden layer.

    Each transposed plan row's `real` is the width that continues down the
    net (the hidden width of the layer's input, the part before the skip's
    encoding), `col` where the encoding starts (skip layers), and SCALE
    marks the 1/sqrt(2) of a skip. `embed_none` also takes a net with no
    encoding (`mma_pack.check_sdf_net`)."""
    if perm is not None:
        ws = ws[:-1] + [ws[-1][:, perm]]
        bs = bs[:-1] + [bs[-1][perm]]
    fwd = sdf_chain_fwd(icfg, ws, bs, embed_none)
    return (fwd, *sdf_chain_t(icfg, ws, 0 if perm is None else perm.index(0)))


def sdf_chain_fwd(icfg: mlp.ImplicitNetConfig, ws: list, bs: list,
                  embed_none: bool = False):
    """`sdf_chains`' `fwd` alone, the output layer's columns as in `ws`."""
    mma_pack.check_sdf_net(icfg, embed_none)
    dims = icfg.layer_dims()
    d0, n = dims[0], len(dims) - 1
    if n - 1 in icfg.skip_in:
        raise ValueError("a skip into the SDF net's output layer is not "
                         "supported")
    layers = []
    for l in range(n):
        flags = (mma_pack.SKIP_IN if l in icfg.skip_in else 0) | (
            mma_pack.SCALE if l + 1 in icfg.skip_in else 0)
        col = dims[l] - d0 if l in icfg.skip_in else 0
        layers.append(dict(w=ws[l], b=bs[l], flags=flags, col=col))
    return mma_pack.pack_chain(layers)


def sdf_chain_t(icfg: mlp.ImplicitNetConfig, ws: list, sdf_col: int = 0):
    """`sdf_chains`' transposed chain: (`sdft`, `rev`, `wsdf_col`) from the
    materialized weights with the output layer's columns already in the
    kernel's order, the sdf in column `sdf_col`."""
    dims = icfg.layer_dims()
    d0, n = dims[0], len(dims) - 1
    tl = []
    for l in range(n - 1, -1, -1):
        if l == 0:
            real, col, flags = 0, 0, 0
        elif l in icfg.skip_in:
            real, col, flags = dims[l] - d0, dims[l] - d0, mma_pack.SCALE
        else:
            real, col, flags = dims[l], mma_pack.NO_COL, 0
        tl.append(dict(w=ws[l].t(), b=None, real=real, col=col, flags=flags))
    sdft = mma_pack.pack_chain(tl)
    rev = mma_pack.PackedMlp(sdft.weights, sdft.biases,
                             np.ascontiguousarray(sdft.plan[1:]))
    wsdf_col = torch.zeros(int(rev.plan[0, 0]), dtype=torch.float32,
                           device=ws[0].device)
    wsdf_col[:ws[-1].shape[0]] = ws[-1][:, sdf_col].to(torch.bfloat16).float()
    return sdft, rev, wsdf_col


class _KernelLayout:
    """The nets in the kernels' layouts, from materialized weights:

    * `fwd`, `sdft`, `rev`, `wsdf_col`: the SDF chain (`sdf_chains`), its
      output layer as [features | sdf];
    * `rad`, `radt`: the radiance chain (first layer's rows as
      [features | PE(view)]) and its transpose, last layer first;
    * with a light head (`lcfg`), `light` and `lightt`: the light chain,
      its first layer's rows the features in the net's order, and its
      transpose, last layer first (`n_light` layers; 0 without)."""

    def __init__(self, icfg: mlp.ImplicitNetConfig,
                 rcfg: mlp.RenderingNetConfig, w: CoreWeights,
                 lcfg: mlp.ImplicitNetConfig | None = None):
        F = icfg.feature_vector_size
        if icfg.d_out != 1 or F % 2:
            raise ValueError("render_core: needs d_out 1 and an even "
                             "feature width")
        if rcfg.embed_type != "positional" or rcfg.d_in != 3:
            raise ValueError("render_core: the radiance net takes the "
                             "positional view encoding")
        dims = icfg.layer_dims()
        d0 = dims[0]
        n = len(dims) - 1
        self.fwd, self.sdft, self.rev, self.wsdf_col = sdf_chains(
            icfg, [t.detach().float() for t in w.ws_sdf],
            [t.detach().float() for t in w.bs_sdf], _sdf_perm(F))
        rdims = rcfg.layer_dims()
        vdim = rdims[0] - F
        wr = [t.detach().float() for t in w.ws_rad]
        br = [t.detach().float() for t in w.bs_rad]
        wr[0] = wr[0][_rad_perm(vdim, F)]
        nr = len(wr)
        self.rad = mma_pack.pack_chain(
            [dict(w=wr[l], b=br[l]) for l in range(nr)])
        self.radt = mma_pack.pack_chain(
            [dict(w=wr[l].t(), b=None, real=F if l == 0 else rdims[l])
             for l in range(nr - 1, -1, -1)])
        chains = [self.fwd, self.sdft, self.rad, self.radt]
        self.light = self.lightt = None
        nl = n_layers(lcfg)
        if lcfg is not None:
            check_light_net(icfg, lcfg)
            wl = [t.detach().float() for t in w.ws_l]
            bl = [t.detach().float() for t in w.bs_l]
            self.light = mma_pack.pack_chain(
                [dict(w=wl[l], b=bl[l]) for l in range(nl)])
            self.lightt = mma_pack.pack_chain(
                [dict(w=wl[l].t(), b=None) for l in range(nl - 1, -1, -1)])
            chains += [self.light, self.lightt]
        widest = max(p.max_width for p in chains)
        if widest > _MAX_WIDTH:
            raise ValueError(f"render_core: layer width above {_MAX_WIDTH}")
        if n > _MAX_SDF or nr > _MAX_RAD or nl > _MAX_LIGHT:
            raise ValueError("render_core: too many layers for the kernels")
        self.n_sdf, self.n_rad, self.n_light = n, nr, nl
        self.F, self.vdim = F, vdim
        self.lda = mma_pack.row_stride(widest)
        self.ldd = mma_pack.row_stride(int(self.fwd.plan[:-1, 1].max()))
        self.ldg = mma_pack.round_up(d0, 8)
        for name, smem in (("fwd", fwd_smem(self)),
                           ("bwd", bwd_smem(self))):
            if smem > _MAX_SMEM:
                raise ValueError(f"render_core_{name}: needs {smem} bytes of "
                                 "shared memory")
        self.mx, self.md = icfg.multires, rcfg.multires
        self.shapes = (tuple(tuple(t.shape) for t in w.ws_sdf),
                       tuple(tuple(t.shape) for t in w.ws_rad),
                       tuple(tuple(t.shape) for t in w.ws_l[:nl]))

    def unpack_grads(self, out: torch.Tensor, plan: "_BwdPlan"):
        """K4's flat output -> (dws_sdf, dbs_sdf, dws_rad, dbs_rad, dws_l,
        dbs_l) in the nets' own layouts (the light lists empty without a
        light head): padding cut, the SDF output layer's columns and the
        radiance input layer's rows put back in order (the gather's
        transpose, as autodiff of `fused_train.py:737-754` does)."""
        (w_sdf, w_rad, w_l), n, nr = self.shapes, self.n_sdf, self.n_rad
        dws, dbs = [], []
        for p, (k, m) in enumerate(list(w_sdf) + list(w_rad) + list(w_l)):
            K, N = plan.dims[p]
            dws.append(out[plan.out[p]:plan.out[p] + K * N].view(K, N)[:k,
                                                                        :m])
            o = plan.out_db + plan.db[p]
            dbs.append(out[o:o + m])
        inv_sdf = np.argsort(_sdf_perm(self.F))
        dws[n - 1] = dws[n - 1][:, inv_sdf]
        dbs[n - 1] = dbs[n - 1][inv_sdf]
        inv_rad = np.argsort(_rad_perm(self.vdim, self.F))
        dws[n] = dws[n][inv_rad]
        c = n + nr
        return dws[:n], dbs[:n], dws[n:c], dbs[n:c], dws[c:], dbs[c:]


def fwd_smem(k) -> int:
    """The shared memory (bytes) of K3's and K5's kernel (`fwd_smem_bytes`
    in csrc/common.cuh) for a layout `k` with `n_sdf`, `n_light`, `lda`,
    `ldd` and `ldg`: with a light head, one more activation buffer."""
    return (2 * ((2 + (k.n_light > 0)) * _ROWS * k.lda
                 + (k.n_sdf - 1) * _ROWS * k.ldd)
            + 4 * _ROWS * (3 + 3 + 1 + k.ldg))


def bwd_smem(k) -> int:
    """The shared memory (bytes) of K4's and K6's sweep kernel
    (`bwd_smem_bytes` in csrc/common.cuh) for a layout `k` with
    `n_sdf`, `n_light`, `lda`, `ldd` and `ldg`."""
    return (2 * ((2 + (k.n_light > 0)) * _ROWS * k.lda
                 + (k.n_sdf - 1) * _ROWS * k.ldd)
            + 4 * _ROWS * (3 + 3 + 8 + 4 + k.ldg + k.lda))


class _BwdPlan:
    """K4's scratch layout at n points, and the int64 table that tells the
    kernel where everything is (read in this order by `read_scratch` in
    csrc/common.cuh); with no radiance and no light layers (`k.n_rad`,
    `k.n_light` 0) it is K6's, and with `streams=4, rows=16, stash=False,
    sdf_col=True` K12's. All sizes in elements; bf16 arrays live in one
    scratch buffer, f32 arrays in another, each array 16-byte aligned.

    Per SDF layer l (K_l x N_l padded): `ax` (streams np, K_l) the layer's
    input in each stream (K4/K6: [da_l ; X_l]; K12: [h ; t_0 ; t_1 ;
    t_2]), `br` (streams np, N_l) their cotangents ([r_l ; dz_l]; [dz ;
    rho_0 ; rho_1 ; rho_2]), so dW_l = ax^T br over streams np rows; with
    `stash`, `dzx` (np, N_l) the second-order term injected into z_l and
    `ah` (np, K_l, f32) d sdf / d h_l. With `sdf_col`, the output layer's
    product takes the first stream alone (`br` np rows): its other
    streams' cotangents live in the sdf column only, and their rank-3
    share of that column is summed per block after the bias rows (at
    `col_db`, K_l wide). Per radiance layer: `rx` (np, K) its inputs,
    `rdz` (np, N) its output cotangents; per light layer likewise `lx`
    and `ldz` (a hidden layer's `ldz` holds its activation derivative
    until the backward overwrites it with dz). `dbpart` (blocks, tb) each
    block of `rows` points' bias-gradient sums. Each weight gradient is
    summed over `splits[p]` point ranges of `chunk[p]` rows into
    `part[p]`, then the ranges are added in order (deterministic). `out`
    (f32): every dW_p (K x N; SDF, radiance, light layers), then the tb
    bias gradients (and with `sdf_col` the column's share)."""

    def __init__(self, k, n: int, streams: int = 2, rows: int = _ROWS,
                 stash: bool = True, sdf_col: bool = False):
        ns, nr, nl = k.n_sdf, k.n_rad, k.n_light
        # the weight-gradient products step over _ROWS (32) rows
        self.np = np_ = mma_pack.round_up(max(n, 1), _ROWS)
        self.blocks = np_ // rows
        Ks, Ns = [int(v) for v in k.fwd.plan[:, 0]], [int(v) for v in
                                                      k.fwd.plan[:, 1]]
        rad = k.rad.plan if nr else np.zeros((0, 8), np.int32)
        Kr, Nr = [int(v) for v in rad[:, 0]], [int(v) for v in rad[:, 1]]
        light = k.light.plan if nl else np.zeros((0, 8), np.int32)
        Kl, Nl = [int(v) for v in light[:, 0]], [int(v) for v in light[:, 1]]
        self.dims = (list(zip(Ks, Ns)) + list(zip(Kr, Nr))
                     + list(zip(Kl, Nl)))
        self.n16 = self.n32 = 0

        def take16(size):
            o, self.n16 = self.n16, self.n16 + mma_pack.round_up(size, 8)
            return o

        def take32(size):
            o, self.n32 = self.n32, self.n32 + mma_pack.round_up(size, 4)
            return o

        m_sdf = [streams * np_] * ns
        if sdf_col:
            m_sdf[-1] = np_
        self.ax = [take16(streams * np_ * K) for K in Ks]
        self.br = [take16(m * N) for m, N in zip(m_sdf, Ns)]
        if stash:
            self.dzx = [take16(np_ * N) for N in Ns[:-1]] + [-1]
            self.ah = [-1] + [take32(np_ * K) for K in Ks[1:]]
        else:
            self.dzx = self.ah = [-1] * ns
        self.rx = [take16(np_ * K) for K in Kr]
        self.rdz = [take16(np_ * N) for N in Nr]
        self.lx = [take16(np_ * K) for K in Kl]
        self.ldz = [take16(np_ * N) for N in Nl]
        self.col_db = sum(Ns) + sum(Nr) + sum(Nl)
        self.tb = self.col_db + (Ks[-1] if sdf_col else 0)
        self.db = list(np.cumsum([0] + Ns + Nr + Nl)[:-1].astype(int))
        self.dbpart = take32(self.blocks * self.tb)
        self.splits, self.chunk, self.part, self.out = [], [], [], []
        o = 0
        for (K, N), m in zip(self.dims, m_sdf + [np_] * (nr + nl)):
            steps = m // _ROWS
            per = -(-steps // min(_MAX_SPLITS, steps))
            self.splits.append(-(-steps // per))
            self.chunk.append(per * _ROWS)
            self.part.append(take32(self.splits[-1] * K * N))
            self.out.append(o)
            o += K * N
        self.out_db = o
        self.n_out = o + self.tb
        self.table = np.ascontiguousarray(np.asarray(
            self.ax + self.br + self.dzx + self.ah + self.rx + self.rdz
            + self.lx + self.ldz
            + [self.dbpart, self.tb] + self.db + self.splits + self.chunk
            + self.part + self.out + [self.out_db], np.int64))


class RenderCorePack:
    """The nets (the light net too, if there is one), plus their kernel
    layout when they live on the card (packed once, for eval)."""

    def __init__(self, implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet,
                 light: mlp.ImplicitNet | None = None):
        self.implicit, self.rendering, self.light = implicit, rendering, light
        self.kernel = None
        if next(implicit.parameters()).is_cuda:
            with torch.no_grad():
                self.kernel = _KernelLayout(
                    implicit.cfg, rendering.cfg,
                    CoreWeights.of(implicit, rendering, light),
                    None if light is None else light.cfg)


# ---- plain versions ---------------------------------------------------------

def render_core_train_plain(icfg, rcfg, w: CoreWeights, x: torch.Tensor,
                            dirs: torch.Tensor, lcfg=None,
                            detach_light: bool = True):
    """(sdf (N, 1), grad (N, 3), rgb (N, 3)) in f32, and with a light head
    (`lcfg`, weights in `w.ws_l`, `w.bs_l`) the light mask (N, 1) of the
    light net on relu(features), the features detached with
    `detach_light`; differentiable with respect to the weights in `w`,
    through the spatial gradient too (`create_graph`). Unclamped; `x`
    and `dirs` are constants."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = mlp.implicit_apply(icfg, w.ws_sdf, w.bs_sdf, xg)
        sdf, feat = out[:, :1], out[:, 1:]
        (grad,) = torch.autograd.grad(sdf, xg, torch.ones_like(sdf),
                                      create_graph=True)
        rgb = mlp.rendering_apply(rcfg, w.ws_rad, w.bs_rad, dirs, feat)
        if lcfg is None:
            return sdf, grad, rgb
        lf = torch.relu(feat)
        if detach_light:
            lf = lf.detach()
        return sdf, grad, rgb, mlp.implicit_apply(lcfg, w.ws_l, w.bs_l, lf)


def render_core_plain(implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet,
                      x: torch.Tensor, dirs: torch.Tensor,
                      light: mlp.ImplicitNet | None = None):
    """(sdf (N, 1), grad (N, 3), rgb (N, 3)) in f32 (chunked), and with a
    light net the light mask (N, 1)."""
    outs = []
    for xc, dc in zip(x.split(_PLAIN_CHUNK), dirs.split(_PLAIN_CHUNK)):
        sdf, feat, grad = mlp.sdf_outputs(implicit, xc)
        with torch.no_grad():
            o = (sdf, grad, rendering(dc, feat))
            if light is not None:
                o += (light(torch.relu(feat)),)
            outs.append(o)
    if not outs:
        z = x.new_zeros((0, 1))
        o = (z, x.new_zeros((0, 3)), x.new_zeros((0, 3)))
        return o if light is None else o + (x.new_zeros((0, 1)),)
    return tuple(torch.cat(o) for o in zip(*outs))


def _sphere_clamp(icfg, x, sdf, grad):
    if icfg.sdf_bounding_sphere > 0.0:
        norm = torch.linalg.norm(x, dim=-1, keepdim=True)
        sphere = icfg.sphere_scale * (icfg.sdf_bounding_sphere - norm)
        sphere_grad = -icfg.sphere_scale * x / torch.clamp(norm, min=1e-12)
        grad = torch.where(sphere < sdf, sphere_grad, grad)
        sdf = torch.minimum(sdf, sphere)
    return sdf, grad


# ---- kernels ----------------------------------------------------------------

def _check_points(x, dirs, name):
    mma_pack.check_input(x, "x", cols=3)
    mma_pack.check_input(dirs, "dirs", cols=3)
    if dirs.shape != x.shape or dirs.device != x.device:
        raise ValueError(f"{name}: x and dirs differ in shape or device")


def _light_args(k: _KernelLayout) -> tuple:
    """The light net's kernel arguments (null pointers without one)."""
    if not k.n_light:
        return None, None, None, 0
    return (k.light.weights.data_ptr(), k.light.biases.data_ptr(),
            k.light.plan.ctypes.data, k.n_light)


def _launch_fwd(k: _KernelLayout, x: torch.Tensor, dirs: torch.Tensor):
    global launches, light_launches
    _check_points(x, dirs, "render_core_fwd")
    if k.fwd.weights.device != x.device:
        raise ValueError("render_core_fwd: the weights are not on the "
                         "points' device")
    n = x.shape[0]
    sdf = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    lmask = (torch.empty((n, 1), dtype=torch.float32, device=x.device)
             if k.n_light else None)
    lib = build.load_library()
    err = lib.i2sdf_render_core_fwd(
        x.data_ptr(), dirs.data_ptr(), n,
        k.fwd.weights.data_ptr(), k.fwd.biases.data_ptr(),
        k.fwd.plan.ctypes.data, k.fwd.n_layers,
        k.rev.weights.data_ptr(), k.rev.plan.ctypes.data, k.rev.n_layers,
        k.wsdf_col.data_ptr(),
        k.rad.weights.data_ptr(), k.rad.biases.data_ptr(),
        k.rad.plan.ctypes.data, k.rad.n_layers, *_light_args(k),
        k.mx, k.md, k.lda, k.ldd, k.ldg,
        sdf.data_ptr(), grad.data_ptr(), rgb.data_ptr(),
        None if lmask is None else lmask.data_ptr(),
        mma_pack.stream_of(x))
    build.check(err, "render_core_fwd")
    if k.n_light:
        light_launches += 1
        return sdf, grad, rgb, lmask
    launches += 1
    return sdf, grad, rgb


def render_core_fwd(p: RenderCorePack, x: torch.Tensor, dirs: torch.Tensor):
    """(sdf (N, 1), grad (N, 3), rgb (N, 3)) at points x along unit dirs,
    and with a light net the light mask (N, 1). CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if not x.is_cuda:
        return render_core_plain(p.implicit, p.rendering, x, dirs, p.light)
    if p.kernel is None:
        raise ValueError("render_core_fwd: the nets' weights are not on the "
                         "card")
    sdf, grad, *rest = _launch_fwd(p.kernel, x, dirs)
    sdf, grad = _sphere_clamp(p.implicit.cfg, x, sdf, grad)
    return (sdf, grad, *rest)


def pack_cotangents(n: int, c_sdf, c_grad, c_rgb, device,
                    c_lm=None) -> torch.Tensor:
    """(N, 8) f32 [c_grad 3 | c_sdf 1 | c_rgb 3 | c_lm 1], zeros for a
    missing one (the TPU kernel's cotangent stream,
    `fused_train.py:578-583`)."""
    cot = torch.zeros((n, 8), dtype=torch.float32, device=device)
    for sl, c in ((slice(0, 3), c_grad), (slice(3, 4), c_sdf),
                  (slice(4, 7), c_rgb), (slice(7, 8), c_lm)):
        if c is not None:
            cot[:, sl] = c.reshape(n, -1)
    return cot


def render_core_bwd(k: _KernelLayout, x: torch.Tensor, dirs: torch.Tensor,
                    cot: torch.Tensor, detach_light: bool = True):
    """K4: the gradients of <cot, [grad | sdf | rgb | lmask]> with respect
    to the materialized weights and biases of the nets (unclamped
    outputs), as (dws_sdf, dbs_sdf, dws_rad, dbs_rad, dws_l, dbs_l) lists
    of f32 tensors (the light lists empty without a light head; with one,
    `detach_light` off lets the light cotangent reach the SDF net through
    the features). CUDA tensors only: the plain backward is autograd of
    `render_core_train_plain`."""
    global bwd_launches, light_bwd_launches
    if not x.is_cuda:
        raise ValueError("render_core_bwd: the kernel takes CUDA tensors; "
                         "the plain backward is autograd of "
                         "render_core_train_plain")
    _check_points(x, dirs, "render_core_bwd")
    mma_pack.check_input(cot, "cot", cols=8)
    if cot.shape[0] != x.shape[0] or k.fwd.weights.device != x.device:
        raise ValueError("render_core_bwd: cotangents, points and weights "
                         "disagree in length or device")
    n = x.shape[0]
    plan = _BwdPlan(k, n)
    ws16 = torch.empty(plan.n16, dtype=torch.bfloat16, device=x.device)
    ws32 = torch.empty(plan.n32, dtype=torch.float32, device=x.device)
    out = torch.empty(plan.n_out, dtype=torch.float32, device=x.device)
    lightt = ((k.lightt.weights.data_ptr(), k.lightt.plan.ctypes.data,
               k.n_light) if k.n_light else (None, None, 0))
    lib = build.load_library()
    err = lib.i2sdf_render_core_bwd(
        x.data_ptr(), dirs.data_ptr(), cot.data_ptr(), n, plan.np,
        k.fwd.weights.data_ptr(), k.fwd.biases.data_ptr(),
        k.fwd.plan.ctypes.data, k.fwd.n_layers,
        k.sdft.weights.data_ptr(), k.sdft.plan.ctypes.data,
        k.sdft.n_layers, k.wsdf_col.data_ptr(),
        k.rad.weights.data_ptr(), k.rad.biases.data_ptr(),
        k.rad.plan.ctypes.data, k.rad.n_layers,
        k.radt.weights.data_ptr(), k.radt.plan.ctypes.data,
        k.radt.n_layers, *_light_args(k), *lightt, int(bool(detach_light)),
        k.mx, k.md, k.lda, k.ldd, k.ldg,
        ws16.data_ptr(), ws32.data_ptr(), plan.table.ctypes.data,
        out.data_ptr(), mma_pack.stream_of(x))
    build.check(err, "render_core_bwd")
    if k.n_light:
        light_bwd_launches += 1
    else:
        bwd_launches += 1
    return k.unpack_grads(out, plan)


class RenderCoreTrain(torch.autograd.Function):
    """The training op on the card: K3 forward, K4 backward.

    apply(icfg, rcfg, lcfg, detach_light, x, dirs, *weights.flat()) ->
    (sdf, grad, rgb), and the light mask with a light head (`lcfg`),
    unclamped. Gradients flow to the weights and biases only (x and dirs
    are constants: sampler depths and cameras)."""

    @staticmethod
    def forward(ctx, icfg, rcfg, lcfg, detach_light, x, dirs, *flat):
        w = CoreWeights.unflat(flat, n_layers(icfg), n_layers(rcfg),
                               n_layers(lcfg))
        outs = _launch_fwd(_KernelLayout(icfg, rcfg, w, lcfg), x, dirs)
        ctx.save_for_backward(x, dirs, *flat)
        ctx.cfgs = (icfg, rcfg, lcfg, detach_light)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, c_sdf, c_grad, c_rgb, c_lm=None):
        x, dirs, *flat = ctx.saved_tensors
        icfg, rcfg, lcfg, detach_light = ctx.cfgs
        w = CoreWeights.unflat(flat, n_layers(icfg), n_layers(rcfg),
                               n_layers(lcfg))
        cot = pack_cotangents(x.shape[0], c_sdf, c_grad, c_rgb, x.device,
                              c_lm)
        grads = render_core_bwd(_KernelLayout(icfg, rcfg, w, lcfg), x, dirs,
                                cot, detach_light)
        return (None,) * 6 + tuple(t for g in grads for t in g)


def render_core_train(icfg, rcfg, w: CoreWeights, x: torch.Tensor,
                      dirs: torch.Tensor, plain: bool = False, lcfg=None,
                      detach_light: bool = True):
    """(sdf (N, 1), grad (N, 3), rgb (N, 3)), and with a light head
    (`lcfg`) the light mask (N, 1); bounding-sphere clamped,
    differentiable with respect to `w`. CPU tensors take the plain
    version; CUDA tensors launch K3 now and K4 in the backward (or
    raise). `plain=True` takes the plain version on any device (to hold
    the kernels against it on the card)."""
    if x.is_cuda and not plain:
        sdf, grad, *rest = RenderCoreTrain.apply(
            icfg, rcfg, lcfg, detach_light, x, dirs, *w.flat())
    else:
        sdf, grad, *rest = render_core_train_plain(icfg, rcfg, w, x, dirs,
                                                   lcfg, detach_light)
    sdf, grad = _sphere_clamp(icfg, x, sdf, grad)
    return (sdf, grad, *rest)
