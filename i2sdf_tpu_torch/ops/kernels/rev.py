"""K5 `rev_fwd` and K6 `rev_bwd`: the SDF net's outputs and the spatial
gradient of its sdf at points, and the backward of the same function,
through that gradient too.

Replaces `i2sdf_tpu/ops/pallas/fused_rev.py:213 get_rev_op`: its forward
(pallas_call at `:244`) is K5 (`csrc/rev_fwd.cu`: the forward and the
reverse sweep of K6's sweeps), its backward (`:294`) is K6
(`csrc/rev_bwd.cu`, K4's wgmma sweeps without the radiance net). Each
CUDA source's header says what bounds it and how it is built.

* `RevStages`: K5's and K6's one pack, the SDF net as K4 packs it (K3's
  stage chain `render_core.core_sdf_layers` and K4's transposed one
  `render_core.t_sdf_layers`, here down to layer 0), gathered from the
  net's flat weights through a layout built once for its shapes. K6's
  plan is K4's (`render_core.plan_for` with this pack as both packs),
  K5's its own table of the same items (`K5Plan`).
* `rev_fwd(k, x)` -> (out (N, 1 + F), grad (N, 3)) and
  `rev_bwd(k, x, c_out, c_g)` -> (dws, dbs): the launches, CUDA tensors
  only.
* `rev_plain(icfg, ws, bs, x)`: the same function in plain f32 PyTorch,
  the gradient by autograd with `create_graph`, so that autograd gives
  the second order. The CPU path and the tests use it; on the card it
  only serves as the yardstick the kernels are held to.
* `RevOp`: the `torch.autograd.Function` on the card, K5 forward, K6
  backward, both on the forward's `RevStages` (one pack a step). It takes
  the materialized weights (the gradients to v and g come from autograd
  of the materialization) and gives no gradient to x, as
  `fused_rev.py:319-324` does.
* `sdf_outputs_rev(implicit, x, plain=False)` -> (sdf, feat, grad), the
  bounding-sphere clamp composed outside the kernels: the counterpart of
  `fused_rev.py:329 sdf_outputs_fused_rev`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...models import mlp
from . import build, mma_pack, render_core

launches = 0      # K5 launches since the last reset_launch_counts()
bwd_launches = 0  # K6 launches since the last reset_launch_counts()


def unpack_grads(shapes, out: torch.Tensor, plan):
    """A weight-gradient launch's flat output (`plan.out[p]`: layer p's
    padded (K, N) gradient; `plan.out_db + plan.db[p]`: its bias's) ->
    (dws, dbs) cut to the (in, out) `shapes` of the net's layers (K6's
    and K12's)."""
    dws, dbs = [], []
    for p, (k, m) in enumerate(shapes):
        K, N = plan.dims[p]
        dws.append(out[plan.out[p]:plan.out[p] + K * N].view(K, N)[:k, :m])
        o = plan.out_db + plan.db[p]
        dbs.append(out[o:o + m])
    return dws, dbs


@functools.lru_cache(maxsize=None)
def _inv_perm(F: int, device: torch.device) -> torch.Tensor:
    """The kernel's output-layer columns [features | sdf] back to the
    net's order, as an index on `device` (the unpack copies nothing from
    the host)."""
    return torch.from_numpy(np.argsort(render_core._sdf_perm(F))).to(device)


class RevStages:
    """K5's and K6's pack of the SDF net from materialized (in, out) weights
    and biases, as K4 packs the same net (so K6 takes K4's `K4Plan`, with
    this pack as both of K4's):

    * `sdf`: K3's SDF stage chain (`render_core.core_sdf_layers`: the
      hidden layers, then the output layer as the sdf alone and the
      features; K6 loads the hidden layers' stages only, K5 all);
    * `t`: K4's transposed SDF layers n-1 .. 1 (`render_core.t_sdf_layers`,
      the output layer's input rows as [features | sdf]), then layer 0
      (K5's last product); `tsdf` the plan of layers n-1 .. 1 (K6's);
    * `wsdf`: W_{n-1}[:, sdf] rounded to bf16 (f32, zero-padded), d sdf /
      d h of the last hidden layer.

    Both chains are gathered from the net's flat weights by a layout
    built once for the net's shapes (`mma_pack.chain_index`): the same
    bits as `mma_pack.pack_stage_chain` of the layers, in two gathers a
    chain. K12 (`sdf_grad.py`), which is K6, takes this pack too, and with
    `embed_none` a net with no encoding (frequency count 0)."""

    rad = light = None
    n_rad = n_light = 0
    trad = tlight = np.zeros((0, 8), np.int32)

    def __init__(self, icfg: mlp.ImplicitNetConfig, ws, bs,
                 embed_none: bool = False):
        if icfg.d_out != 1 or icfg.feature_vector_size % 8:
            raise ValueError("rev: needs d_out 1 and a feature width "
                             "that is a multiple of 8")
        # here, not only in the layout's first build, which is kept
        mma_pack.check_sdf_net(icfg, embed_none)
        self.shapes = tuple(tuple(t.shape) for t in ws)

        def chains(ws, bs):
            return (render_core.core_sdf_layers(icfg, ws, bs, embed_none),
                    render_core.t_sdf_layers(icfg, ws, first=True))

        ix = mma_pack.chain_index(("rev", icfg, self.shapes), chains,
                                  self.shapes, (256, 256))
        dev = ws[0].device
        K = self.shapes[-1][0]
        with torch.no_grad():
            w, b = mma_pack.flat_sources(ws, bs)
            sdf, t = ix.on(dev)
            self.sdf = mma_pack.gather_chain(sdf, w, b)
            self.t = mma_pack.gather_chain(t, w, b)
            self.wsdf = torch.zeros(mma_pack.round_up(K, 64) + 8,
                                    dtype=torch.float32, device=dev)
            self.wsdf[:K] = ws[-1].detach()[:, 0].float().to(torch.bfloat16)
        self._inv = _inv_perm(icfg.feature_vector_size, torch.device(dev))
        self.n_sdf = len(ws)
        self.tsdf = np.ascontiguousarray(self.t.plan[:self.n_sdf - 1])
        self.F = icfg.feature_vector_size
        self.mx = icfg.multires if icfg.embed_type else 0
        plans = (self.sdf.plan, self.t.plan)
        if (max(int(p[:, 1].max()) for p in plans) > render_core._K3_WIDTH
                or max(int(p[:, 0].max()) for p in plans)
                > render_core._K3_RAD_K):
            raise ValueError("rev: a layer wider than "
                             f"{render_core._K3_WIDTH}")
        if self.sdf.n_layers > render_core._MAX_LAYERS:
            raise ValueError("rev: too many layers")

    def unpack_grads(self, out: torch.Tensor, plan):
        """K6's flat output -> (dws, dbs) in the net's shapes, the output
        layer's columns back in the net's order [sdf | features]."""
        dws, dbs = unpack_grads(self.shapes, out, plan)
        dws[-1] = dws[-1].index_select(1, self._inv)
        dbs[-1] = dbs[-1].index_select(0, self._inv)
        return dws, dbs


def plan_for(k: RevStages, n: int) -> render_core.K4Plan:
    """K6's plan at n points: K4's, for this pack (cached by shapes)."""
    return render_core.plan_for(k, k, n, False)


class K5Plan:
    """K5's scratch at n points (bytes) and the ring table its producer
    walks, from `RevStages` (depends only on the shapes: `k5_plan_for`
    caches it), in `render_core.K4Plan`'s formats:

    * `fwd`: the SDF chain's rows (`k.sdf.plan`) with 64 added to layer
      0's K: layer 0 reads the encoding as a hi/lo pair of bf16 tiles, the
      low half from column 64, on W_0's stages twice;
    * `regions[REG_Q][l]` = (byte offset of block 0's tile, bytes a
      block): hidden layer l's stash q in f32, two 32 KB slots in
      accumulator order (`f32_at`), the only scratch K5 takes (`reg`:
      the kernel's copy);
    * `script`: (items, 4) int64, the ring's items in the order the
      consumers take them: each hidden layer's weight stages (layer 0's
      twice) and two staging slots for its q; the output layer's two
      products (the sdf
      alone, then the features); a wait for the forward's stores; q of
      the last hidden layer; each transposed hidden layer's stages
      (layers n-2 .. 1) with the q of the layer below; layer 0's
      transposed stages."""

    tb = 0   # no bias rows

    def __init__(self, k: RevStages, n: int):
        R = render_core
        self.blocks = B = -(-max(n, 1) // R._K4_POINTS)
        fwd, t, ns = k.sdf.plan, k.t.plan, k.n_sdf
        self.fwd = fwd.copy()
        self.fwd[0, 0] += 64
        self.regions = [[(0, 0)] * R._K4_REG_LAYERS
                        for _ in range(R._REG_KINDS)]
        self.scratch_bytes = 0
        for l in range(ns - 1):
            self.regions[R.REG_Q][l] = (self.scratch_bytes, 2 * R._SLOT)
            self.scratch_bytes += B * 2 * R._SLOT
        reg = np.zeros(R._REG_KINDS * R._K4_REG_LAYERS * 2 + 2, np.int64)
        for l in range(ns - 1):
            reg[2 * (R.REG_Q * R._K4_REG_LAYERS + l):][:2] = \
                self.regions[R.REG_Q][l]
        self.reg = reg

        def q(l):
            off, stride = self.regions[R.REG_Q][l]
            return [(R._LOAD | R._B_SCRATCH << 8, off + h, stride, R._SLOT)
                    for h in (0, R._SLOT)]

        items = []
        for l in range(ns - 1):
            items += R.weight_items(R._B_SDF, fwd[l]) * (2 if l == 0 else 1)
            items += [(R._STAGE, 0, 0, 0)] * 2
        items += R.weight_items(R._B_SDF, fwd[ns - 1])
        items += R.weight_items(R._B_SDF, fwd[ns])
        items += [(R._WAIT, 1, 0, 0)] + q(ns - 2)
        for l in range(ns - 2, 0, -1):
            items += R.weight_items(R._B_T, t[ns - 1 - l]) + q(l - 1)
        items += R.weight_items(R._B_T, t[ns - 1])
        self.script = np.ascontiguousarray(np.asarray(items, np.int64))
        self.dev = None   # (reg, script) on the card, at first launch


_K5_PLANS: dict = {}


def k5_plan_for(k: RevStages, n: int) -> K5Plan:
    """K5's plan for these shapes at n points, built once."""
    key = (k.sdf.plan.tobytes(), k.t.plan.tobytes(),
           -(-max(n, 1) // render_core._K4_POINTS))
    plan = _K5_PLANS.get(key)
    if plan is None:
        plan = _K5_PLANS[key] = K5Plan(k, n)
    return plan


def _on_device(plan, device):
    """The plan's (reg, script) on `device`, copied at its first launch
    there."""
    if plan.dev is None or plan.dev[0].device != device:
        plan.dev = (torch.from_numpy(plan.reg).to(device),
                    torch.from_numpy(plan.script).to(device))
    return plan.dev


# ---- plain version ----------------------------------------------------------

def rev_plain(icfg: mlp.ImplicitNetConfig, ws, bs, x: torch.Tensor):
    """(out (N, 1 + F) = [sdf | features], grad (N, 3) = d sdf / d x) in
    f32, unclamped, differentiable with respect to `ws` and `bs` through
    the gradient too (`create_graph`). `x` is a constant."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = mlp.implicit_apply(icfg, ws, bs, xg)
        (grad,) = torch.autograd.grad(out[:, :1], xg,
                                      torch.ones_like(out[:, :1]),
                                      create_graph=True)
    return out, grad


# ---- kernels ----------------------------------------------------------------

def rev_fwd(k: RevStages, x: torch.Tensor):
    """K5: (out (N, 1 + F) = [sdf | features], grad (N, 3)), unclamped."""
    global launches
    if not x.is_cuda:
        raise ValueError("rev_fwd: the kernel takes CUDA tensors; the plain "
                         "version is rev_plain")
    mma_pack.check_input(x, "x", cols=3)
    if k.sdf.weights.device != x.device:
        raise ValueError("rev_fwd: the weights are not on the points' "
                         "device")
    n = x.shape[0]
    out = torch.empty((n, k.F + 1), dtype=torch.float32, device=x.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n == 0:
        return out, grad
    plan = k5_plan_for(k, n)
    reg, script = _on_device(plan, x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    lib = build.load_library()
    err = lib.i2sdf_rev_fwd(
        x.data_ptr(), n, plan.blocks, k.F + 1, k.sdf.weights.data_ptr(),
        k.sdf.biases.data_ptr(), plan.fwd.ctypes.data, k.sdf.n_layers,
        k.t.weights.data_ptr(), k.t.plan.ctypes.data, k.t.n_layers,
        k.wsdf.data_ptr(), k.mx, k.F, scratch.data_ptr(), reg.data_ptr(),
        script.data_ptr(), plan.script.shape[0], out.data_ptr(),
        grad.data_ptr(), mma_pack.stream_of(x))
    build.check(err, "rev_fwd")
    launches += 1
    return out, grad


def rev_bwd(k: RevStages, x: torch.Tensor, c_out: torch.Tensor,
            c_g: torch.Tensor):
    """K6: the gradients of <c_out, out> + <c_g, grad> (unclamped outputs)
    with respect to the materialized weights and biases, as (dws, dbs)
    lists of f32 tensors in the net's shapes."""
    global bwd_launches
    grads, launched = bwd_launch("i2sdf_rev_bwd", "rev_bwd", k, x, c_out,
                                 c_g)
    bwd_launches += launched
    return grads


def bwd_launch(symbol: str, name: str, k: RevStages, x: torch.Tensor,
               c_out: torch.Tensor, c_g: torch.Tensor):
    """K6's sweep, products and sums through the C entry `symbol` (K6's
    `i2sdf_rev_bwd`, or K12's `i2sdf_sdf_grad_bwd`, which is K6 under its
    own name) on K6's plan: ((dws, dbs), 1 if it launched, 0 at no
    points)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors; the plain "
                         "version is rev_plain")
    mma_pack.check_input(x, "x", cols=3)
    mma_pack.check_input(c_out, "c_out", cols=k.F + 1)
    mma_pack.check_input(c_g, "c_g", cols=3)
    n = x.shape[0]
    if (c_out.shape[0] != n or c_g.shape[0] != n
            or c_out.device != x.device or c_g.device != x.device
            or k.sdf.weights.device != x.device):
        raise ValueError(f"{name}: cotangents, points and weights disagree "
                         "in length or device")
    plan = plan_for(k, n)
    reg, script = _on_device(plan, x.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    ws32 = torch.empty(plan.n32, dtype=torch.float32, device=x.device)
    out = torch.empty(plan.n_out, dtype=torch.float32, device=x.device)
    if n:
        err = getattr(build.load_library(), symbol)(
            x.data_ptr(), c_out.data_ptr(), c_g.data_ptr(), n, plan.blocks,
            k.F + 1, k.sdf.weights.data_ptr(), k.sdf.biases.data_ptr(),
            k.sdf.plan.ctypes.data, k.sdf.n_layers, k.t.weights.data_ptr(),
            k.tsdf.ctypes.data, k.tsdf.shape[0], k.wsdf.data_ptr(), k.mx,
            k.F, scratch.data_ptr(), ws32.data_ptr(), reg.data_ptr(),
            script.data_ptr(), plan.script.shape[0], plan.jobs.ctypes.data,
            plan.jobs.shape[0], plan.db_host.ctypes.data, out.data_ptr(),
            mma_pack.stream_of(x))
        build.check(err, name)
    else:
        out.zero_()
    return k.unpack_grads(out, plan), int(n > 0)


class RevOp(torch.autograd.Function):
    """The op on the card: K5 forward, K6 backward. The forward's pack
    (`RevStages`) stays in `ctx` for the backward: one pack a step.

    apply(icfg, x, *ws, *bs) -> (out, grad), unclamped. Gradients flow to
    the weights and biases only; x is a constant (eikonal points)."""

    @staticmethod
    def forward(ctx, icfg, x, *flat):
        n = len(flat) // 2
        ctx.stages = RevStages(icfg, flat[:n], flat[n:])
        ctx.save_for_backward(x)
        return rev_fwd(ctx.stages, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, c_out, c_g):
        (x,) = ctx.saved_tensors
        dws, dbs = rev_bwd(ctx.stages, x, c_out.float().contiguous(),
                           c_g.float().contiguous())
        return (None, None, *dws, *dbs)


def sdf_outputs_rev(implicit: mlp.ImplicitNet, x: torch.Tensor,
                    plain: bool = False):
    """(sdf (N, 1), features (N, F), grad (N, 3)) of the bounding-sphere
    clamped SDF, differentiable with respect to the net's parameters,
    through the gradient too. CPU tensors take the plain version; CUDA
    tensors launch K5 now and K6 in the backward (or raise). `plain=True`
    takes the plain version on any device (to hold the kernels against
    it on the card)."""
    cfg = implicit.cfg
    lins = implicit.layers()
    ws, bs = [l.weight() for l in lins], [l.b for l in lins]
    if x.is_cuda and not plain:
        out, grad = RevOp.apply(cfg, x, *ws, *bs)
    else:
        out, grad = rev_plain(cfg, ws, bs, x)
    sdf, grad = render_core._sphere_clamp(cfg, x, out[:, :1], grad)
    return sdf, out[:, 1:], grad
