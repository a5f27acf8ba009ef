"""K8 `bg_core_fwd` and K9 `bg_core_bwd`: the NeRF++ background's pair of
MLPs, and its weight gradients.

Replaces `i2sdf_tpu/ops/pallas/fused_bg.py:209 get_bg_core_op`: its
forward (pallas_call at `:289`) is K8 (`csrc/bg_core.cu`), its backward
(`:328`) is K9 (`csrc/bg_core_bwd.cu`). Each CUDA source's header says
what bounds it and how it is built.

The op: (the background nets' weights, x4 (N, 4) points on the inverted
sphere, dirs (N, 3) unit view directions) -> (sigma (N, 1), rgb (N, 3)),
the implicit net on x4 (its first output sigma, the rest the features)
and the nerf-mode radiance net on [PE(view), features] with a sigmoid.
Its backward gives weight and bias cotangents only: nothing upstream of
x4 and dirs is trainable (`fused_bg.py:361-376`).

* `bg_core(icfg, rcfg, w, x4, dirs)`: the training op. On the card it is
  `BgCore`, a `torch.autograd.Function` whose forward launches K8 and
  whose backward launches K9 (which recomputes the forward); it takes the
  *materialized* weights (weight norm applied outside by autograd).
* `bg_core_eval(pack, x4, dirs)`: the eval forward, weights packed once.
* `bg_core_plain`: the same function in plain f32 PyTorch, differentiable
  by autograd; the CPU path and the tests use it, and on the card it is
  only the yardstick the kernels are held to.

The kernels' layout (`BgLayout`): the implicit net's last layer's columns
as [features | sigma], the radiance net's first layer's rows as
[features | PE(view)] (JAX's own contract, undone for the gradients
here); the implicit layers 1.. and the radiance layers transposed for
K9, cut to the rows that continue down the nets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...models import mlp
from . import build, mma_pack, render_core
from .render_core import n_layers

launches = 0      # K8 launches since the last reset_launch_counts()
bwd_launches = 0  # K9 launches since the last reset_launch_counts()

_FWD_ROWS = 64           # points per block of K8 (kBgRows)
_BWD_ROWS = 32           # points per block of K9's sweep (kSweepRows)
_MAX_IMP, _MAX_RAD = 16, 8   # layer slots of the kernels' plans
_MAX_JOBS = 24           # weight-gradient products K9 takes (kMaxJobs)


@dataclasses.dataclass(frozen=True)
class BgWeights:
    """Materialized (in, out) weights and biases of the two nets, in the
    nets' own layouts (what autograd differentiates)."""
    ws_i: tuple
    bs_i: tuple
    ws_r: tuple
    bs_r: tuple

    @classmethod
    def of(cls, implicit: mlp.ImplicitNet,
           rendering: mlp.RenderingNet) -> "BgWeights":
        li, lr = implicit.layers(), rendering.layers()
        return cls(tuple(l.weight() for l in li), tuple(l.b for l in li),
                   tuple(l.weight() for l in lr), tuple(l.b for l in lr))

    def flat(self) -> list:
        return [*self.ws_i, *self.bs_i, *self.ws_r, *self.bs_r]

    @classmethod
    def unflat(cls, ts, n_i: int, n_r: int) -> "BgWeights":
        ts = list(ts)
        a = 2 * n_i
        return cls(tuple(ts[:n_i]), tuple(ts[n_i:a]), tuple(ts[a:a + n_r]),
                   tuple(ts[a + n_r:a + 2 * n_r]))


def check_bg_nets(icfg: mlp.ImplicitNetConfig,
                  rcfg: mlp.RenderingNetConfig) -> None:
    """The background nets the kernels run (`supports_bg_core`,
    `fused_bg.py:48-55`, with the shapes the kernels' layout needs)."""
    if icfg.output_activation is not None or icfg.d_out != 1:
        raise ValueError("bg_core: the implicit net needs one raw output "
                         "(sigma) before its features")
    if icfg.feature_vector_size % 2 or icfg.feature_vector_size < 2:
        raise ValueError("bg_core: needs an even feature width")
    if rcfg.embed_type != "positional" or rcfg.d_in != 3:
        raise ValueError("bg_core: the radiance net takes the positional "
                         "view encoding")
    n = n_layers(icfg)
    if n < 2 or 0 in icfg.skip_in or n - 1 in icfg.skip_in:
        raise ValueError("bg_core: needs 2 or more implicit layers, no skip "
                         "into the first or the last")


class BgLayout:
    """The background nets in the kernels' layouts, from materialized
    weights:

    * `imp`: the implicit chain, its output columns [features | sigma];
    * `impt`: its layers n-1 .. 1 transposed (last first), each cut to
      the rows of the hidden part of the layer's input (a skip layer's
      encoding rows dropped, SCALE marking its 1/sqrt(2)); `real` is that
      hidden width;
    * `rad`: the radiance chain, its first layer's rows [features |
      PE(view)];
    * `radt`: its layers transposed (last first), layer 0 cut to the
      feature rows."""

    def __init__(self, icfg: mlp.ImplicitNetConfig,
                 rcfg: mlp.RenderingNetConfig, w: BgWeights):
        check_bg_nets(icfg, rcfg)
        F = icfg.feature_vector_size
        dims = icfg.layer_dims()
        d0, ni = dims[0], len(dims) - 1
        wi = [t.detach().float() for t in w.ws_i]
        bi = [t.detach().float() for t in w.bs_i]
        # the output layer's columns as [features | sigma], as K3's
        perm = render_core._sdf_perm(F)
        wi[-1], bi[-1] = wi[-1][:, perm], bi[-1][perm]
        skip = set(icfg.skip_in)
        self.imp = mma_pack.pack_chain([dict(
            w=wi[l], b=bi[l],
            flags=((mma_pack.SKIP_IN if l in skip else 0)
                   | (mma_pack.SCALE if l + 1 in skip else 0)),
            col=dims[l] - d0 if l in skip else 0) for l in range(ni)])
        tl = []
        for l in range(ni - 1, 0, -1):
            keep = dims[l] - d0 if l in skip else dims[l]
            tl.append(dict(w=wi[l][:keep].t(), b=None, real=keep,
                           flags=mma_pack.SCALE if l in skip else 0))
        self.impt = mma_pack.pack_chain(tl)
        rdims = rcfg.layer_dims()
        vdim = rdims[0] - F
        wr = [t.detach().float() for t in w.ws_r]
        br = [t.detach().float() for t in w.bs_r]
        wr[0] = wr[0][render_core._rad_perm(vdim, F)]
        nr = len(wr)
        self.rad = mma_pack.pack_chain(
            [dict(w=wr[l], b=br[l]) for l in range(nr)])
        self.radt = mma_pack.pack_chain(
            [dict(w=(wr[l][:F] if l == 0 else wr[l]).t(), b=None,
                  real=F if l == 0 else rdims[l])
             for l in range(nr - 1, -1, -1)])
        widest = max(p.max_width for p in (self.imp, self.impt, self.rad,
                                           self.radt))
        if widest > render_core._MAX_WIDTH:
            raise ValueError("bg_core: layer width above "
                             f"{render_core._MAX_WIDTH}")
        if ni > _MAX_IMP or nr > _MAX_RAD or ni + nr > _MAX_JOBS:
            raise ValueError("bg_core: too many layers for the kernels")
        self.n_imp, self.n_rad, self.F, self.vdim = ni, nr, F, vdim
        self.d_in = icfg.d_in
        self.fx = icfg.multires if icfg.embed_type else 0
        self.fv = rcfg.multires
        self.lda = mma_pack.row_stride(widest)
        for name, smem in (("fwd", fwd_smem(self)), ("bwd", bwd_smem(self))):
            if smem > render_core._MAX_SMEM:
                raise ValueError(f"bg_core_{name}: needs {smem} bytes of "
                                 "shared memory")
        self.shapes = (tuple(tuple(t.shape) for t in w.ws_i),
                       tuple(tuple(t.shape) for t in w.ws_r))

    def unpack_grads(self, out: torch.Tensor, plan: "_BgBwdPlan"):
        """K9's flat output -> (dws_i, dbs_i, dws_r, dbs_r) in the nets'
        own layouts: padding cut, the implicit output layer's columns and
        the radiance input layer's rows put back in order."""
        ni = self.n_imp
        dws, dbs = [], []
        for p, (k, m) in enumerate(self.shapes[0] + self.shapes[1]):
            K, N = plan.dims[p]
            dws.append(out[plan.out[p]:plan.out[p] + K * N].view(K, N)[:k,
                                                                        :m])
            o = plan.out_db + plan.db[p]
            dbs.append(out[o:o + m])
        inv = np.argsort(render_core._sdf_perm(self.F))
        dws[ni - 1], dbs[ni - 1] = dws[ni - 1][:, inv], dbs[ni - 1][inv]
        dws[ni] = dws[ni][np.argsort(render_core._rad_perm(self.vdim,
                                                           self.F))]
        return dws[:ni], dbs[:ni], dws[ni:], dbs[ni:]


def fwd_smem(k: BgLayout) -> int:
    """K8's shared memory (bytes; `bg_fwd_smem_bytes` in csrc/bg_core.cu):
    two activation buffers, the points, the directions and sigma."""
    return 2 * 2 * _FWD_ROWS * k.lda + 4 * _FWD_ROWS * (k.d_in + 3 + 1)


def bwd_smem(k: BgLayout) -> int:
    """K9's sweep shared memory (bytes; `bg_bwd_smem_bytes` in
    csrc/bg_core_bwd.cu): two activation buffers, the points, directions,
    cotangents, rgb and the f32 dz the bias sums take."""
    return (2 * 2 * _BWD_ROWS * k.lda
            + 4 * _BWD_ROWS * (k.d_in + 3 + 4 + 4 + k.lda))


class _BgBwdPlan:
    """K9's scratch layout at n points and the int64 table that tells the
    kernel where everything is (read in this order by `i2sdf_bg_core_bwd`
    in csrc/bg_core_bwd.cu). All sizes in elements; bf16 arrays in one
    scratch buffer, f32 arrays in another, each 16-byte aligned.

    Per implicit layer l (K_l x N_l padded): `x` (np, K_l) its input,
    `dz` (np, N_l) its output cotangent (a hidden layer's activation
    derivative until the backward overwrites it); per radiance layer `rx`
    and `rdz` likewise. `dbpart` (blocks, tb): each block's bias-gradient
    sums. dW_p = x^T dz over np rows, summed over `splits[p]` ranges of
    `chunk[p]` rows into `part[p]`, then the ranges added in order. `out`
    (f32): every dW_p (K x N; implicit, then radiance layers), then the tb
    bias gradients."""

    def __init__(self, k: BgLayout, n: int):
        self.np = np_ = mma_pack.round_up(max(n, 1), _BWD_ROWS)
        self.blocks = np_ // _BWD_ROWS
        self.dims = [(int(K), int(N)) for K, N in
                     np.concatenate([k.imp.plan[:, :2], k.rad.plan[:, :2]])]
        ni = k.n_imp
        self.n16 = self.n32 = 0

        def take16(size):
            o, self.n16 = self.n16, self.n16 + mma_pack.round_up(size, 8)
            return o

        def take32(size):
            o, self.n32 = self.n32, self.n32 + mma_pack.round_up(size, 4)
            return o

        x = [take16(np_ * K) for K, _ in self.dims[:ni]]
        dz = [take16(np_ * N) for _, N in self.dims[:ni]]
        rx = [take16(np_ * K) for K, _ in self.dims[ni:]]
        rdz = [take16(np_ * N) for _, N in self.dims[ni:]]
        Ns = [N for _, N in self.dims]
        self.tb = sum(Ns)
        self.db = [int(v) for v in np.cumsum([0] + Ns)[:-1]]
        dbpart = take32(self.blocks * self.tb)
        steps = np_ // _BWD_ROWS
        per = -(-steps // min(render_core._MAX_SPLITS, steps))
        splits = -(-steps // per)
        self.out, o, part = [], 0, []
        for K, N in self.dims:
            part.append(take32(splits * K * N))
            self.out.append(o)
            o += K * N
        self.out_db = o
        self.n_out = o + self.tb
        n_jobs = len(self.dims)
        self.table = np.ascontiguousarray(np.asarray(
            x + dz + rx + rdz + [dbpart, self.tb] + self.db
            + [splits] * n_jobs + [per * _BWD_ROWS] * n_jobs + part
            + self.out + [self.out_db], np.int64))


class BgPack:
    """The background nets, plus their kernel layout when they live on the
    card (packed once, for eval)."""

    def __init__(self, implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet):
        self.implicit, self.rendering = implicit, rendering
        self.kernel = None
        if next(implicit.parameters()).is_cuda:
            with torch.no_grad():
                self.kernel = BgLayout(implicit.cfg, rendering.cfg,
                                       BgWeights.of(implicit, rendering))


# ---- plain version ----------------------------------------------------------

def bg_core_plain(icfg, rcfg, w: BgWeights, x4: torch.Tensor,
                  dirs: torch.Tensor):
    """(sigma (N, 1), rgb (N, 3)) in f32, differentiable with respect to
    the weights in `w` (x4 and dirs are constants)."""
    out = mlp.implicit_apply(icfg, w.ws_i, w.bs_i, x4)
    return out[:, :1], mlp.rendering_apply(rcfg, w.ws_r, w.bs_r, dirs,
                                           out[:, 1:])


# ---- kernels ----------------------------------------------------------------

def _check_points(k: BgLayout, x4, dirs, name):
    mma_pack.check_input(x4, "x4", cols=k.d_in)
    mma_pack.check_input(dirs, "dirs", cols=3)
    if dirs.shape[0] != x4.shape[0] or dirs.device != x4.device:
        raise ValueError(f"{name}: x4 and dirs differ in length or device")
    if k.imp.weights.device != x4.device:
        raise ValueError(f"{name}: the weights are not on the points' "
                         "device")


def _launch_fwd(k: BgLayout, x4: torch.Tensor, dirs: torch.Tensor):
    global launches
    _check_points(k, x4, dirs, "bg_core_fwd")
    n = x4.shape[0]
    sigma = torch.empty((n, 1), dtype=torch.float32, device=x4.device)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=x4.device)
    lib = build.load_library()
    err = lib.i2sdf_bg_core_fwd(
        x4.data_ptr(), dirs.data_ptr(), n,
        k.imp.weights.data_ptr(), k.imp.biases.data_ptr(),
        k.imp.plan.ctypes.data, k.imp.n_layers,
        k.rad.weights.data_ptr(), k.rad.biases.data_ptr(),
        k.rad.plan.ctypes.data, k.rad.n_layers,
        k.d_in, k.fx, k.fv, k.F, k.lda, sigma.data_ptr(), rgb.data_ptr(),
        mma_pack.stream_of(x4))
    build.check(err, "bg_core_fwd")
    launches += 1
    return sigma, rgb


def bg_core_bwd(k: BgLayout, x4: torch.Tensor, dirs: torch.Tensor,
                cot: torch.Tensor):
    """K9: the gradients of <cot, [sigma | rgb]> (cot (N, 4) f32) with
    respect to the materialized weights and biases of both nets, as
    (dws_i, dbs_i, dws_r, dbs_r) lists of f32 tensors. CUDA tensors only:
    the plain backward is autograd of `bg_core_plain`."""
    global bwd_launches
    if not x4.is_cuda:
        raise ValueError("bg_core_bwd: the kernel takes CUDA tensors; the "
                         "plain backward is autograd of bg_core_plain")
    _check_points(k, x4, dirs, "bg_core_bwd")
    mma_pack.check_input(cot, "cot", cols=4)
    if cot.shape[0] != x4.shape[0] or cot.device != x4.device:
        raise ValueError("bg_core_bwd: cotangents and points disagree in "
                         "length or device")
    n = x4.shape[0]
    plan = _BgBwdPlan(k, n)
    ws16 = torch.empty(plan.n16, dtype=torch.bfloat16, device=x4.device)
    ws32 = torch.empty(plan.n32, dtype=torch.float32, device=x4.device)
    out = torch.empty(plan.n_out, dtype=torch.float32, device=x4.device)
    lib = build.load_library()
    err = lib.i2sdf_bg_core_bwd(
        x4.data_ptr(), dirs.data_ptr(), cot.data_ptr(), n, plan.np,
        k.imp.weights.data_ptr(), k.imp.biases.data_ptr(),
        k.imp.plan.ctypes.data, k.imp.n_layers,
        k.impt.weights.data_ptr(), k.impt.plan.ctypes.data,
        k.rad.weights.data_ptr(), k.rad.biases.data_ptr(),
        k.rad.plan.ctypes.data, k.rad.n_layers,
        k.radt.weights.data_ptr(), k.radt.plan.ctypes.data,
        k.d_in, k.fx, k.fv, k.F, k.lda, ws16.data_ptr(), ws32.data_ptr(),
        plan.table.ctypes.data, out.data_ptr(), mma_pack.stream_of(x4))
    build.check(err, "bg_core_bwd")
    bwd_launches += 1
    return k.unpack_grads(out, plan)


class BgCore(torch.autograd.Function):
    """The training op on the card: K8 forward, K9 backward.

    apply(icfg, rcfg, x4, dirs, *weights.flat()) -> (sigma, rgb).
    Gradients flow to the weights and biases only. The nets are packed
    once, in the forward, and the backward takes that layout."""

    @staticmethod
    def forward(ctx, icfg, rcfg, x4, dirs, *flat):
        w = BgWeights.unflat(flat, n_layers(icfg), n_layers(rcfg))
        ctx.layout = BgLayout(icfg, rcfg, w)
        ctx.save_for_backward(x4, dirs)
        return _launch_fwd(ctx.layout, x4, dirs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, c_sigma, c_rgb):
        x4, dirs = ctx.saved_tensors
        n = x4.shape[0]
        cot = torch.zeros((n, 4), dtype=torch.float32, device=x4.device)
        if c_sigma is not None:
            cot[:, :1] = c_sigma
        if c_rgb is not None:
            cot[:, 1:] = c_rgb
        grads = bg_core_bwd(ctx.layout, x4, dirs, cot)
        return (None,) * 4 + tuple(t for g in grads for t in g)


def bg_core(icfg, rcfg, w: BgWeights, x4: torch.Tensor, dirs: torch.Tensor,
            plain: bool = False):
    """(sigma (N, 1), rgb (N, 3)), differentiable with respect to `w`. CPU
    tensors take the plain version; CUDA tensors launch K8 now and K9 in
    the backward (or raise). `plain=True` takes the plain version on any
    device (to hold the kernels against it on the card)."""
    if x4.is_cuda and not plain:
        return BgCore.apply(icfg, rcfg, x4, dirs, *w.flat())
    return bg_core_plain(icfg, rcfg, w, x4, dirs)


def bg_core_eval(p: BgPack, x4: torch.Tensor, dirs: torch.Tensor):
    """The eval forward (no gradient): CPU tensors take the plain version;
    CUDA tensors launch K8 (or raise)."""
    if not x4.is_cuda:
        with torch.no_grad():
            return bg_core_plain(p.implicit.cfg, p.rendering.cfg,
                                 BgWeights.of(p.implicit, p.rendering), x4,
                                 dirs)
    if p.kernel is None:
        raise ValueError("bg_core_fwd: the nets' weights are not on the card")
    return _launch_fwd(p.kernel, x4, dirs)
