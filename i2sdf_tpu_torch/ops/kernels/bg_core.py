"""K8 `bg_core_fwd` and K9 `bg_core_bwd`: the NeRF++ background's pair of
MLPs, and its weight gradients.

Replaces `i2sdf_tpu/ops/pallas/fused_bg.py:209 get_bg_core_op`: its
forward (pallas_call at `:289`) is K8 (`csrc/bg_core.cu`), its backward
(`:328`) is K9 (`csrc/bg_core_bwd.cu`), both on the Hopper layer
primitive `csrc/wgmma_layer.cuh`. Each CUDA source's header says what
bounds it and how it is built.

The op: (the background nets' weights, x4 (N, 4) points on the inverted
sphere, dirs (N, 3) unit view directions) -> (sigma (N, 1), rgb (N, 3)),
the implicit net on x4 (its first output sigma, the rest the features)
and the nerf-mode radiance net on [PE(view), features] with a sigmoid.
Its backward gives weight and bias cotangents only: nothing upstream of
x4 and dirs is trainable (`fused_bg.py:361-376`).

* `bg_core(icfg, rcfg, w, x4, dirs)`: the training op. On the card it is
  `BgCore`, a `torch.autograd.Function` whose forward packs the nets once
  (`BgStages`) and launches K8, and whose backward launches K9 (which
  recomputes the forward) on that pack; it takes the *materialized*
  weights (weight norm applied outside by autograd).
* `bg_core_eval(pack, x4, dirs)`: the eval forward, weights packed once.
* `bg_core_plain`: the same function in plain f32 PyTorch, differentiable
  by autograd; the CPU path and the tests use it, and on the card it is
  only the yardstick the kernels are held to.

The kernels' layout (`BgStages`): both nets as stage images
(`mma_pack.pack_stage_chain`), the implicit net's last layer as two
products, sigma then the features (its columns [features | sigma], as
K3's), the radiance net's first layer's rows as [features | PE(view)]
(JAX's own contract, undone for the gradients here); and for K9 the
implicit layers n-1 .. 1 and the radiance layers transposed, cut to the
rows that continue down the nets. K9's scratch, ring table and
weight-gradient jobs: `BgPlan`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...models import mlp
from . import build, mma_pack, render_core
from .render_core import (REG_DZ, REG_Q, REG_RDZ, REG_RX, REG_X, n_layers)

launches = 0      # K8 launches since the last reset_launch_counts()
bwd_launches = 0  # K9 launches since the last reset_launch_counts()

_PASS_ROWS = 128     # K8: a pass's columns, the forward stages' rows
_TILE_K = 320        # K8, K9: a tile's five 64-column chunks
_K9_POINTS = 64      # K9: points a block (kPts)


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
    if (rcfg.embed_type != "positional" or rcfg.d_in != 3
            or rcfg.mode != "nerf"):
        raise ValueError("bg_core: the radiance net takes the positional "
                         "view encoding (nerf mode)")
    n = n_layers(icfg)
    if n < 2 or 0 in icfg.skip_in or n - 1 in icfg.skip_in:
        raise ValueError("bg_core: needs 2 or more implicit layers, no skip "
                         "into the first or the last")


def _sdf_layers(icfg: mlp.ImplicitNetConfig, ws: list, bs: list) -> list:
    """The implicit net's hidden layers for the packer: weights, biases,
    the skip's flags and column."""
    dims, skip = icfg.layer_dims(), set(icfg.skip_in)
    return [dict(w=ws[l], b=bs[l],
                 flags=((mma_pack.SKIP_IN if l in skip else 0)
                        | (mma_pack.SCALE if l + 1 in skip else 0)),
                 col=dims[l] - dims[0] if l in skip else 0)
            for l in range(len(dims) - 2)]


def _bg_chains(icfg: mlp.ImplicitNetConfig, rcfg: mlp.RenderingNetConfig,
               ws_i, bs_i, ws_r, bs_r) -> tuple:
    """`BgStages`' three chains as `mma_pack.pack_stage_chain`'s layers,
    from the nets' (in, out) weights and biases: `imp`, `rad` and `t`."""
    F = icfg.feature_vector_size
    dims, rdims = icfg.layer_dims(), rcfg.layer_dims()
    d0, ni, nr = dims[0], len(dims) - 1, len(rdims) - 1
    wi, bi, wr, br = list(ws_i), list(bs_i), list(ws_r), list(bs_r)
    perm = render_core._sdf_perm(F)
    wi[-1], bi[-1] = wi[-1][:, perm], bi[-1][perm]
    imp = (_sdf_layers(icfg, wi, bi)
           + [dict(w=wi[-1][:, F:], b=bi[-1][F:]),
              dict(w=wi[-1][:, :F], b=bi[-1][:F])])
    wr[0] = wr[0][render_core._rad_perm(rdims[0] - F, F)]
    rad = [dict(w=a, b=b) for a, b in zip(wr, br)]
    skip, t = set(icfg.skip_in), []
    for l in range(ni - 1, 0, -1):
        keep = dims[l] - d0 if l in skip else dims[l]
        t.append(dict(w=wi[l][:keep].t(), real=keep,
                      flags=mma_pack.SCALE if l in skip else 0))
    t += [dict(w=(wr[l][:F] if l == 0 else wr[l]).t(),
               real=F if l == 0 else rdims[l])
          for l in range(nr - 1, -1, -1)]
    return imp, rad, t


class BgStages:
    """The background nets as stage images, from materialized weights:

    * `imp`: the implicit net's hidden layers, then its output layer as
      two products in the order K8 takes them: sigma alone (an N = 8
      product), then the features (the first F columns of [features |
      sigma], `render_core._sdf_perm`); stages of at most 128 rows of W^T
      (a 256-wide layer comes in two passes, `mma_pack.pack_stages`);
    * `rad`: the radiance net, its first layer's rows as [features |
      PE(view)] (`render_core._rad_perm`), stages of at most 128 rows;
    * `t`, packed at its first use (K9's; K8 does not read it): K9's
      transposed products (stage images of W_l^T's transpose, full
      stages): `timp`, the implicit layers n-1 .. 1, the output layer's
      input rows in [features | sigma] order, each cut to the rows of
      the hidden part of the layer's input (a skip layer's encoding rows
      dropped, SCALE marking its 1/sqrt(2); `real` that hidden width);
      then `trad`, the radiance layers n_r-1 .. 0, layer 0 cut to the
      feature rows.

    The layers are `_bg_chains`'; each chain is gathered from the nets'
    flat weights by a layout built once for the nets' shapes
    (`mma_pack.chain_index`), the same bits as `mma_pack.pack_stage_chain`
    of the layers. K9 takes the forward stages whole: a stage of a layer in
    passes is its passes' stages of one chunk side by side
    (`BgPlan.script`)."""

    def __init__(self, icfg: mlp.ImplicitNetConfig,
                 rcfg: mlp.RenderingNetConfig, w: BgWeights):
        check_bg_nets(icfg, rcfg)
        ni = n_layers(icfg)

        def chains(ws, bs):
            return _bg_chains(icfg, rcfg, ws[:ni], bs[:ni], ws[ni:], bs[ni:])

        shapes = tuple(tuple(t.shape) for t in (*w.ws_i, *w.ws_r))
        self._index = mma_pack.chain_index(
            ("bg", icfg, rcfg, shapes), chains, shapes,
            (_PASS_ROWS, _PASS_ROWS, 256))
        ix = self._index.host
        with torch.no_grad():
            self._w, self._b = mma_pack.flat_sources(
                (*w.ws_i, *w.ws_r), (*w.bs_i, *w.bs_r))
            on = self._index.on(self._w.device)
            self.imp = mma_pack.gather_chain(on[0], self._w, self._b)
            self.rad = mma_pack.gather_chain(on[1], self._w, self._b)
        self._t = None
        dims, rdims = icfg.layer_dims(), rcfg.layer_dims()
        ni, nr = len(dims) - 1, len(rdims) - 1
        self.t_plan = ix[2].plan
        self.timp = np.ascontiguousarray(self.t_plan[:ni - 1])
        self.trad = np.ascontiguousarray(self.t_plan[ni - 1:])
        plans = (self.imp.plan, self.rad.plan, self.t_plan)
        if max(int(p[:, 0].max()) for p in plans) > _TILE_K:
            raise ValueError(f"bg_core: a layer deeper than {_TILE_K}")
        if self.imp.n_layers > render_core._MAX_LAYERS or nr > 8:
            raise ValueError("bg_core: too many layers for the kernels")
        F = icfg.feature_vector_size
        self.n_imp, self.n_rad, self.F, self.vdim = ni, nr, F, rdims[0] - F
        self.d_in = icfg.d_in
        self.fx = icfg.multires if icfg.embed_type else 0
        self.fv = rcfg.multires
        self.shapes = (tuple(tuple(t.shape) for t in w.ws_i),
                       tuple(tuple(t.shape) for t in w.ws_r))

    @property
    def t(self) -> mma_pack.PackedMlp:
        if self._t is None:
            self._t = self.pack_t()
        return self._t

    def pack_t(self) -> mma_pack.PackedMlp:
        """K9's transposed chain (`t` packs it once, at its first read)."""
        with torch.no_grad():
            return mma_pack.gather_chain(self._index.on(self._w.device)[2],
                                         self._w, self._b)

    def unpack_grads(self, out: torch.Tensor, plan: "BgPlan"):
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


_chunks = render_core._chunks
_CHUNK, _SLOT = render_core._CHUNK, render_core._SLOT
# ring table items and blobs (`ItemKind`, `Bases` in csrc/wgmma_sweep.cuh):
# a stage of a layer in passes is one item of two bulk copies (_LOAD2)
_LOAD, _STAGE, _LOAD2 = render_core._LOAD, render_core._STAGE, 3
_B_IMP, _B_RAD, _B_T = render_core._B_SDF, render_core._B_RAD, render_core._B_T


class BgPlan:
    """K9's scratch at n points (bytes), the ring table its producer walks
    and its weight-gradient jobs, from `BgStages` (`st`), laid out as
    `render_core.K4Plan`'s (its region kinds, table items and jobs). All of
    it depends only on the shapes (`plan_for` caches it).

    * `regions[kind][l]` = (byte offset of block 0's tile, bytes a
      block): each 64-point block's tiles as the sweep stores them (64-row
      chunks of 64 columns in the 128-byte swizzle, 8 KB each). The
      weight gradients' operands: `REG_X`, `REG_DZ` per implicit layer
      (the output layer's dz [features | sigma]), `REG_RX`, `REG_RDZ` per
      radiance layer; the stash: `REG_Q`, s = softplus100'(z) of each
      hidden implicit layer. Then every block's bias-gradient row
      (`dbpart`, `tb` f32 columns; weight gradient p's at `db[p]`), and
      32 KB of slack that the products' 256-column B reads may run into.
    * `script`: (items, 4) int64, the ring's items in the order the sweep
      takes them: [kind | base << 8, byte offset, bytes a block, bytes]; a
      load (a weight stage from a chain's blob, a stash or mask tile from
      the scratch), a stage of a layer in passes (`_LOAD2`: two copies of
      half the bytes, the second from the offset plus the third field), a
      staging slot handed out empty, or a wait until the sweep has
      completed that many sweeps' stores.
    * `jobs`: (p, 18) int64 per weight gradient, K4's `WJob` fields with
      one operand pair: dW_l = X_l^T dz_l (implicit layers, then radiance
      layers); `dims` their (K, N) in kernel order."""

    def __init__(self, st: BgStages, n: int):
        self.blocks = B = -(-max(n, 1) // _K9_POINTS)
        imp, rad = st.imp.plan, st.rad.plan
        ni, nr, nh = st.n_imp, st.n_rad, st.n_imp - 1
        Ks = [int(v) for v in imp[:nh, 0]] + [int(imp[ni, 0])]
        Ns = [int(v) for v in imp[:nh, 1]] + [st.F + 1]
        self.scratch_bytes = 0
        self.regions = [[(0, 0)] * render_core._K4_REG_LAYERS
                        for _ in range(render_core._REG_KINDS)]

        def take(kind, l, chunks):
            self.regions[kind][l] = (self.scratch_bytes, chunks * _CHUNK)
            self.scratch_bytes += B * chunks * _CHUNK

        for l in range(ni):
            take(REG_X, l, _chunks(Ks[l]))
            take(REG_DZ, l, _chunks(Ns[l]))
        for l in range(nh):
            take(REG_Q, l, _chunks(imp[l, 1]))
        for l in range(nr):
            take(REG_RX, l, _chunks(rad[l, 0]))
            take(REG_RDZ, l, _chunks(rad[l, 1]))
        real_n = ([int(v) for v in imp[:nh, 2]] + [st.F + 1]
                  + [int(v) for v in rad[:, 2]])
        self.db = [int(v) for v in np.cumsum([0] + real_n)[:-1]]
        self.tb = int(sum(real_n))
        self.dbpart = self.scratch_bytes
        self.scratch_bytes += mma_pack.round_up(B * self.tb * 4, 1024)
        self.scratch_bytes += _SLOT
        self.script = self._script(st)
        per = -(-B // min(render_core._MAX_SPLITS, B))
        splits = -(-B // per)
        rows, self.dims, self.out = [], [], []
        n32 = o = 0
        for p in range(ni + nr):
            kx, kz, l = ((REG_X, REG_DZ, p) if p < ni
                         else (REG_RX, REG_RDZ, p - ni))
            K = Ks[l] if p < ni else int(rad[l, 0])
            (a_off, a_st), (b_off, b_st) = (self.regions[kx][l],
                                            self.regions[kz][l])
            rows.append([a_off, a_off, a_st, a_st, b_off, b_off, b_st, b_st,
                         n32, 1, K, real_n[p], a_st // _CHUNK, B, per,
                         splits, o, 0])
            self.dims.append((K, real_n[p]))
            self.out.append(o)
            n32 += splits * K * real_n[p]
            o += K * real_n[p]
        if len(rows) > render_core._K4_JOBS:
            raise ValueError("bg_core_bwd: too many layers")
        self.jobs = np.ascontiguousarray(np.asarray(rows, np.int64))
        self.n32, self.out_db = n32, o
        self.n_out = o + self.tb
        reg = np.zeros(render_core._REG_KINDS * render_core._K4_REG_LAYERS
                       * 2 + 2 + len(real_n), np.int64)
        for kind, layers in enumerate(self.regions):
            for l, span in enumerate(layers):
                reg[2 * (kind * render_core._K4_REG_LAYERS + l):][:2] = span
        o = render_core._REG_KINDS * render_core._K4_REG_LAYERS * 2
        reg[o:o + 2] = (self.dbpart, self.tb)
        reg[o + 2:] = self.db
        self.reg = reg
        self.db_host = np.asarray([self.dbpart, self.tb, self.out_db],
                                  np.int64)
        self.dev = None   # (reg, script) on the card, at first launch

    def _script(self, st: BgStages) -> np.ndarray:
        items, state = [], {"done": 0, "waited": 0}
        imp, rad = st.imp.plan, st.rad.plan
        ni, nr, nh = st.n_imp, st.n_rad, st.n_imp - 1

        def weights(base, row):
            K, N, woff, R = (int(row[i]) for i in (0, 1, 3, 7))
            C = _chunks(K)
            for c in range(C):
                if R:   # its passes' stages of chunk c, side by side
                    assert N == 2 * R
                    items.append((_LOAD2 | base << 8, 2 * woff + c * R * 128,
                                  C * R * 128, N * 128))
                else:
                    items.append((_LOAD | base << 8, 2 * woff + c * N * 128,
                                  0, N * 128))

        def load(kind, l, nbytes):
            if state["waited"] < state["done"]:
                items.append((render_core._WAIT, state["done"], 0, 0))
                state["waited"] = state["done"]
            off, stride = self.regions[kind][l]
            items.append((_LOAD | render_core._B_SCRATCH << 8, off, stride,
                          nbytes))

        for l in range(nh):                       # 1. implicit forward
            weights(_B_IMP, imp[l])
            items.append((_STAGE, 0, 0, 0))
        weights(_B_IMP, imp[ni])                  # the features
        state["done"] += 1
        for l in range(nr):                       # 2. radiance forward
            weights(_B_RAD, rad[l])
        state["done"] += 1
        for l in range(nr - 1, 0, -1):            # 3. radiance backward
            weights(_B_T, st.trad[nr - 1 - l])
            load(REG_RX, l, _chunks(rad[l, 0]) * _CHUNK)
        weights(_B_T, st.trad[nr - 1])
        for l in range(nh, 0, -1):                # 4. implicit backward
            weights(_B_T, st.timp[nh - l])
            load(REG_Q, l - 1, _chunks(imp[l - 1, 1]) * _CHUNK)
        return np.ascontiguousarray(np.asarray(items, np.int64))


_PLANS: dict = {}


def plan_for(st: BgStages, n: int) -> BgPlan:
    """K9's plan for these shapes, built once."""
    key = (st.imp.plan.tobytes(), st.rad.plan.tobytes(), st.t_plan.tobytes(),
           -(-max(n, 1) // _K9_POINTS))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = BgPlan(st, n)
    return plan


class BgPack:
    """The background nets, plus their stage images when they live on the
    card (packed once, for eval)."""

    def __init__(self, implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet):
        self.implicit, self.rendering = implicit, rendering
        self.kernel = None
        if next(implicit.parameters()).is_cuda:
            with torch.no_grad():
                self.kernel = BgStages(implicit.cfg, rendering.cfg,
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

def _check_points(st: BgStages, x4, dirs, name):
    mma_pack.check_input(x4, "x4", cols=st.d_in)
    mma_pack.check_input(dirs, "dirs", cols=3)
    if dirs.shape[0] != x4.shape[0] or dirs.device != x4.device:
        raise ValueError(f"{name}: x4 and dirs differ in length or device")
    if st.imp.weights.device != x4.device:
        raise ValueError(f"{name}: the weights are not on the points' "
                         "device")


def _launch_fwd(st: BgStages, x4: torch.Tensor, dirs: torch.Tensor):
    global launches
    _check_points(st, x4, dirs, "bg_core_fwd")
    n = x4.shape[0]
    sigma = torch.empty((n, 1), dtype=torch.float32, device=x4.device)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=x4.device)
    lib = build.load_library()
    err = lib.i2sdf_bg_core_fwd(
        x4.data_ptr(), dirs.data_ptr(), n,
        st.imp.weights.data_ptr(), st.imp.biases.data_ptr(),
        st.imp.plan.ctypes.data, st.imp.n_layers,
        st.rad.weights.data_ptr(), st.rad.biases.data_ptr(),
        st.rad.plan.ctypes.data, st.rad.n_layers,
        st.d_in, st.fx, st.fv, st.F, sigma.data_ptr(), rgb.data_ptr(),
        mma_pack.stream_of(x4))
    build.check(err, "bg_core_fwd")
    launches += 1
    return sigma, rgb


def bg_core_bwd(st: BgStages, x4: torch.Tensor, dirs: torch.Tensor,
                cot: torch.Tensor):
    """K9: the gradients of <cot, [sigma | rgb]> (cot (N, 4) f32) with
    respect to the materialized weights and biases of both nets, as
    (dws_i, dbs_i, dws_r, dbs_r) lists of f32 tensors. CUDA tensors only:
    the plain backward is autograd of `bg_core_plain`."""
    global bwd_launches
    if not x4.is_cuda:
        raise ValueError("bg_core_bwd: the kernel takes CUDA tensors; the "
                         "plain backward is autograd of bg_core_plain")
    _check_points(st, x4, dirs, "bg_core_bwd")
    mma_pack.check_input(cot, "cot", cols=4)
    if cot.shape[0] != x4.shape[0] or cot.device != x4.device:
        raise ValueError("bg_core_bwd: cotangents and points disagree in "
                         "length or device")
    n = x4.shape[0]
    plan = plan_for(st, n)
    if plan.dev is None or plan.dev[0].device != x4.device:
        plan.dev = (torch.from_numpy(plan.reg).to(x4.device),
                    torch.from_numpy(plan.script).to(x4.device))
    reg, script = plan.dev
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x4.device)
    ws32 = torch.empty(plan.n32, dtype=torch.float32, device=x4.device)
    out = torch.empty(plan.n_out, dtype=torch.float32, device=x4.device)
    lib = build.load_library()
    err = lib.i2sdf_bg_core_bwd(
        x4.data_ptr(), dirs.data_ptr(), cot.data_ptr(), n, plan.blocks,
        st.imp.weights.data_ptr(), st.imp.biases.data_ptr(),
        st.imp.plan.ctypes.data, st.imp.n_layers,
        st.rad.weights.data_ptr(), st.rad.biases.data_ptr(),
        st.rad.plan.ctypes.data, st.rad.n_layers,
        st.t.weights.data_ptr(), st.timp.ctypes.data, st.timp.shape[0],
        st.trad.ctypes.data, st.d_in, st.fx, st.fv, st.F,
        scratch.data_ptr(), ws32.data_ptr(), reg.data_ptr(),
        script.data_ptr(), plan.script.shape[0], plan.jobs.ctypes.data,
        plan.jobs.shape[0], plan.db_host.ctypes.data, out.data_ptr(),
        mma_pack.stream_of(x4))
    build.check(err, "bg_core_bwd")
    bwd_launches += 1
    return st.unpack_grads(out, plan)


class BgCore(torch.autograd.Function):
    """The training op on the card: K8 forward, K9 backward.

    apply(icfg, rcfg, x4, dirs, *weights.flat()) -> (sigma, rgb).
    Gradients flow to the weights and biases only. The nets are packed
    once, in the forward (`BgStages`), and the backward takes that pack
    (adding its transposed chain)."""

    @staticmethod
    def forward(ctx, icfg, rcfg, x4, dirs, *flat):
        w = BgWeights.unflat(flat, n_layers(icfg), n_layers(rcfg))
        ctx.stages = BgStages(icfg, rcfg, w)
        ctx.save_for_backward(x4, dirs)
        return _launch_fwd(ctx.stages, x4, dirs)

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
        grads = bg_core_bwd(ctx.stages, x4, dirs, cot)
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
