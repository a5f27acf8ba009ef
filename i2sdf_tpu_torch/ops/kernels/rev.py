"""K5 `rev_fwd` and K6 `rev_bwd`: the SDF net's outputs and the spatial
gradient of its sdf at points, and the backward of the same function,
through that gradient too.

Replaces `i2sdf_tpu/ops/pallas/fused_rev.py:213 get_rev_op`: its forward
(pallas_call at `:244`) is K5 (`csrc/rev_fwd.cu`), its backward (`:294`)
is K6 (`csrc/rev_bwd.cu`). Each CUDA source's header says what bounds it
and how it is built.

* `RevLayout`: the SDF net alone in the kernels' layout (weight norm
  materialized, bf16, mma fragment order). Its output layer keeps the
  net's own column order [sdf | features], so neither kernel nor wrapper
  permutes anything.
* `rev_fwd(k, x)` -> (out (N, 1 + F), grad (N, 3)) and
  `rev_bwd(k, x, c_out, c_g)` -> (dws, dbs): the launches, CUDA tensors
  only.
* `rev_plain(icfg, ws, bs, x)`: the same function in plain f32 PyTorch,
  the gradient by autograd with `create_graph`, so that autograd gives
  the second order. The CPU path and the tests use it; on the card it
  only serves as the yardstick the kernels are held to.
* `RevOp`: the `torch.autograd.Function` on the card, K5 forward, K6
  backward. It takes the materialized weights (the gradients to v and g
  come from autograd of the materialization) and gives no gradient to x,
  as `fused_rev.py:319-324` does.
* `sdf_outputs_rev(implicit, x, plain=False)` -> (sdf, feat, grad), the
  bounding-sphere clamp composed outside the kernels: the counterpart of
  `fused_rev.py:329 sdf_outputs_fused_rev`.
"""

from __future__ import annotations

import torch

from ...models import mlp
from . import build, mma_pack, render_core

launches = 0      # K5 launches since the last reset_launch_counts()
bwd_launches = 0  # K6 launches since the last reset_launch_counts()


class RevLayout:
    """The SDF net in K5's and K6's layout, from materialized (in, out)
    weights and biases: `fwd`, `sdft`, `rev` and `wsdf_col` as
    `render_core.sdf_chains` builds them, in the net's column order."""

    def __init__(self, icfg: mlp.ImplicitNetConfig, ws, bs):
        if icfg.d_out != 1:
            raise ValueError("rev: needs d_out 1")
        dims = icfg.layer_dims()
        n = len(dims) - 1
        self.fwd, self.sdft, self.rev, self.wsdf_col = render_core.sdf_chains(
            icfg, [t.detach().float() for t in ws],
            [t.detach().float() for t in bs])
        widest = max(self.fwd.max_width, self.sdft.max_width)
        if widest > render_core._MAX_WIDTH:
            raise ValueError(f"rev: layer width above "
                             f"{render_core._MAX_WIDTH}")
        if n > render_core._MAX_SDF:
            raise ValueError("rev: too many layers for the kernels")
        self.n_sdf, self.out_cols = n, dims[-1]
        self.lda = mma_pack.row_stride(widest)
        self.ldd = mma_pack.row_stride(int(self.fwd.plan[:-1, 1].max()))
        self.ldg = mma_pack.round_up(dims[0], 8)
        for name, smem in (("fwd", fwd_smem(self)),
                           ("bwd", render_core.bwd_smem(self))):
            if smem > render_core._MAX_SMEM:
                raise ValueError(f"rev_{name}: needs {smem} bytes of shared "
                                 "memory")
        self.mx = icfg.multires
        self.shapes = tuple(tuple(t.shape) for t in ws)


def fwd_smem(k: RevLayout) -> int:
    """K5's shared memory (bytes; `fwd_smem_bytes` in csrc/rev_fwd.cu): two
    activation buffers, every hidden layer's activation derivative, and
    per row the point and the encoding's gradient."""
    R = render_core._ROWS
    return (2 * (2 * R * k.lda + (k.n_sdf - 1) * R * k.ldd)
            + 4 * R * (3 + k.ldg))


def unpack_grads(shapes, out: torch.Tensor, plan):
    """A weight-gradient launch's flat output (`plan.out[p]`: layer p's
    padded (K, N) gradient; `plan.out_db + plan.db[p]`: its bias's) ->
    (dws, dbs) cut to the (in, out) `shapes` of the net's layers."""
    dws, dbs = [], []
    for p, (k, m) in enumerate(shapes):
        K, N = plan.dims[p]
        dws.append(out[plan.out[p]:plan.out[p] + K * N].view(K, N)[:k, :m])
        o = plan.out_db + plan.db[p]
        dbs.append(out[o:o + m])
    return dws, dbs


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

def _check(k: RevLayout, x: torch.Tensor, name: str):
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors; the plain "
                         "version is rev_plain")
    mma_pack.check_input(x, "x", cols=3)
    if k.fwd.weights.device != x.device:
        raise ValueError(f"{name}: the weights are not on the points' "
                         "device")


def rev_fwd(k: RevLayout, x: torch.Tensor):
    """K5: (out (N, 1 + F), grad (N, 3)), unclamped."""
    global launches
    _check(k, x, "rev_fwd")
    n = x.shape[0]
    out = torch.empty((n, k.out_cols), dtype=torch.float32, device=x.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n == 0:
        return out, grad
    lib = build.load_library()
    err = lib.i2sdf_rev_fwd(
        x.data_ptr(), n, k.fwd.weights.data_ptr(), k.fwd.biases.data_ptr(),
        k.fwd.plan.ctypes.data, k.fwd.n_layers, k.rev.weights.data_ptr(),
        k.rev.plan.ctypes.data, k.rev.n_layers, k.wsdf_col.data_ptr(),
        k.mx, k.lda, k.ldd, k.ldg, k.out_cols, out.data_ptr(),
        grad.data_ptr(), mma_pack.stream_of(x))
    build.check(err, "rev_fwd")
    launches += 1
    return out, grad


def rev_bwd(k: RevLayout, x: torch.Tensor, c_out: torch.Tensor,
            c_g: torch.Tensor):
    """K6: the gradients of <c_out, out> + <c_g, grad> (unclamped outputs)
    with respect to the materialized weights and biases, as (dws, dbs)
    lists of f32 tensors in the net's shapes."""
    global bwd_launches
    _check(k, x, "rev_bwd")
    mma_pack.check_input(c_out, "c_out", cols=k.out_cols)
    mma_pack.check_input(c_g, "c_g", cols=3)
    n = x.shape[0]
    if (c_out.shape[0] != n or c_g.shape[0] != n
            or c_out.device != x.device or c_g.device != x.device):
        raise ValueError("rev_bwd: cotangents and points disagree in length "
                         "or device")
    plan = render_core._BwdPlan(k, n)
    ws16 = torch.empty(plan.n16, dtype=torch.bfloat16, device=x.device)
    ws32 = torch.empty(plan.n32, dtype=torch.float32, device=x.device)
    out = torch.zeros(plan.n_out, dtype=torch.float32, device=x.device)
    if n:
        lib = build.load_library()
        err = lib.i2sdf_rev_bwd(
            x.data_ptr(), c_out.data_ptr(), c_g.data_ptr(), n, plan.np,
            k.out_cols, k.fwd.weights.data_ptr(), k.fwd.biases.data_ptr(),
            k.fwd.plan.ctypes.data, k.fwd.n_layers,
            k.sdft.weights.data_ptr(), k.sdft.plan.ctypes.data,
            k.sdft.n_layers, k.wsdf_col.data_ptr(), k.mx, k.lda, k.ldd,
            k.ldg, ws16.data_ptr(), ws32.data_ptr(), plan.table.ctypes.data,
            out.data_ptr(), mma_pack.stream_of(x))
        build.check(err, "rev_bwd")
        bwd_launches += 1
    return unpack_grads(k.shapes, out, plan)


class RevOp(torch.autograd.Function):
    """The op on the card: K5 forward, K6 backward.

    apply(icfg, x, *ws, *bs) -> (out, grad), unclamped. Gradients flow to
    the weights and biases only; x is a constant (eikonal points)."""

    @staticmethod
    def forward(ctx, icfg, x, *flat):
        n = len(flat) // 2
        k = RevLayout(icfg, flat[:n], flat[n:])
        out, grad = rev_fwd(k, x)
        ctx.save_for_backward(x)
        ctx.layout = k
        return out, grad

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, c_out, c_g):
        (x,) = ctx.saved_tensors
        dws, dbs = rev_bwd(ctx.layout, x, c_out.float().contiguous(),
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
