"""K11 `sdf_grad_fwd` and K12 `sdf_grad_bwd`: the SDF net's outputs and the
spatial gradient of its sdf at points, by forward-mode tangent streams, and
the backward of the same function, through that gradient too.

Replaces `i2sdf_tpu/ops/pallas/fused_grad.py:250 get_sdf_outputs_op`: its
forward (pallas_call at `:277`) is K11 (`csrc/sdf_grad_fwd.cu`), its
backward (`:323`) is K12 (`csrc/sdf_grad_bwd.cu`). The op computes what
`get_rev_op` (K5/K6, `rev.py`) computes (`fused_rev.py:215-219`): K11 by
the other algorithm, the three tangents d/dx_k riding through the net
beside the activations on mma.sync (`csrc/tangent_common.cuh`), and K12 by
K6's: its wgmma sweeps, products and sums on K6's pack (`rev.RevStages`)
and plan, under K12's own C entry and launch count, so that on the same
inputs its gradients are K6's to the bit. Each CUDA source's header says
what bounds it.

* `embed_tangents` and `sdf_tangents`: the tangent sweep in plain f32
  PyTorch, differentiable with respect to the weights (autograd through
  it gives the second order). The embedding's tangents are arguments, so
  that a check can feed a faulty layout through the same sweep.
* `SdfGradLayout`: the SDF net in K11's layout (weight norm
  materialized, bf16, mma fragment order), the output layer in the net's
  own column order [sdf | features]. A net with no encoding runs as
  frequency count 0: its tangents are e_k.
* `bwd_stages(icfg, ws, bs)`: K12's pack, K6's `rev.RevStages` (a net
  with no encoding too).
* `sdf_grad_fwd(k, x)` -> (out (N, 1 + F), grad (N, 3)) and
  `sdf_grad_bwd(kr, x, c_out, c_g)` -> (dws, dbs): the launches, CUDA
  tensors only.
* `sdf_grad_plain(icfg, ws, bs, x)`: the same function in plain f32
  PyTorch, the gradient by autograd with `create_graph` (`rev.rev_plain`).
  The CPU path and the tests use it; on the card it only serves as the
  yardstick the kernels are held to.
* `SdfGradOp`: the `torch.autograd.Function` on the card, K11 forward,
  K12 backward, both packs built in the forward, no gradient to x
  (`fused_grad.py:341-347`).
* `sdf_outputs_fused_grad(implicit, x, plain=False)` -> (sdf, feat, grad),
  the bounding-sphere clamp composed outside the kernels: the counterpart
  of `fused_grad.py:353 sdf_outputs_fused_grad`.
"""

from __future__ import annotations

import math

import torch

from ...models import mlp
from ...models.embedder import pe_frequencies
from . import build, mma_pack, render_core, rev

launches = 0      # K11 launches since the last reset_launch_counts()
bwd_launches = 0  # K12 launches since the last reset_launch_counts()

_POINTS = 16      # points a block (kTanPoints in csrc/tangent_common.cuh)
_STREAMS = 4      # the primal rows and the three tangents' (kStreams)


# ---- plain versions ---------------------------------------------------------

def embed_tangents(icfg: mlp.ImplicitNetConfig, x: torch.Tensor):
    """(3, N, d0): d emb / d x_k for k = 0, 1, 2. In the block layout
    [x | sin(x f) | cos(x f)] that is [e_k | cos(x f) B_k | -sin(x f) B_k],
    B_k holding the frequencies in axis k's block (`fused_grad.py:49-76`);
    with no encoding, e_k."""
    n = x.shape[0]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)[:, None].expand(3, n,
                                                                      3)
    if not icfg.embed_type:
        return eye
    F = icfg.multires
    freqs = torch.as_tensor(pe_frequencies(F), dtype=x.dtype,
                            device=x.device)
    xf = (x[:, :, None] * freqs).reshape(n, 3 * F)
    sel = torch.block_diag(*[freqs[None]] * 3)[:, None]  # (3, 1, 3F)
    return torch.cat([eye, torch.cos(xf) * sel, -torch.sin(xf) * sel], -1)


def dsoftplus(z: torch.Tensor) -> torch.Tensor:
    """d softplus_beta(z, 100) / dz: sigmoid(100 z), 1 in the linear
    region."""
    return torch.where(100.0 * z > 20.0, torch.ones_like(z),
                       torch.sigmoid(100.0 * z))


def sdf_tangents(icfg: mlp.ImplicitNetConfig, ws, bs, x: torch.Tensor,
                 t_emb: torch.Tensor | None = None,
                 t_skip: torch.Tensor | None = None):
    """(out (N, 1 + F), grad (N, 3)), unclamped, by the tangent sweep in
    f32: per layer z = h W + b, h' = softplus(z), t' = softplus'(z) (t W)
    for the three tangents, the skip's concat (and its tangents') scaled
    by 1/sqrt(2), the output layer's tangents in the sdf column only.
    `t_emb` (3, N, d0) are the tangents of the encoding that enters layer
    0 and `t_skip` those re-injected at the skip (both `embed_tangents` by
    default). Differentiable with respect to `ws` and `bs`."""
    if icfg.output_activation is not None:
        raise ValueError("sdf_tangents: the SDF net has no output "
                         "activation")
    emb = icfg.embed(x)
    if t_emb is None:
        t_emb = embed_tangents(icfg, x)
    if t_skip is None:
        t_skip = t_emb
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    h, t = emb, t_emb
    last = len(ws) - 1
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in icfg.skip_in:
            h = torch.cat([h, emb], -1) * inv_sqrt2
            t = torch.cat([t, t_skip], -1) * inv_sqrt2
        z = h @ w + b
        if l == last:
            return z, (t @ w[:, :1])[..., 0].T
        h, t = mlp.softplus_beta(z, 100.0), dsoftplus(z) * (t @ w)


# The plain version of the op: (out, grad) in f32, unclamped, the gradient
# by autograd with create_graph. K5/K6's op computes the same function.
sdf_grad_plain = rev.rev_plain


# ---- kernel layout ----------------------------------------------------------

class SdfGradLayout:
    """The SDF net in K11's layout, from materialized (in, out) weights
    and biases: `fwd` (layer 0 first, `render_core.sdf_chain_fwd`), in the
    net's column order; `mx` the encoding's frequency count (0: no
    encoding)."""

    def __init__(self, icfg: mlp.ImplicitNetConfig, ws, bs):
        if icfg.d_out != 1 or icfg.output_activation is not None:
            raise ValueError("sdf_grad: needs d_out 1 and no output "
                             "activation")
        dims = icfg.layer_dims()
        n = len(dims) - 1
        self.fwd = render_core.sdf_chain_fwd(
            icfg, [t.detach().float() for t in ws],
            [t.detach().float() for t in bs], embed_none=True)
        if self.fwd.max_width > render_core._MAX_WIDTH:
            raise ValueError(f"sdf_grad: layer width above "
                             f"{render_core._MAX_WIDTH}")
        if n > render_core._MAX_SDF:
            raise ValueError("sdf_grad: too many layers for the kernels")
        self.n_sdf, self.out_cols = n, dims[-1]
        self.lda = mma_pack.row_stride(self.fwd.max_width)
        if fwd_smem(self) > render_core._MAX_SMEM:
            raise ValueError(f"sdf_grad_fwd: needs {fwd_smem(self)} bytes "
                             "of shared memory")
        self.mx = icfg.multires if icfg.embed_type else 0


def fwd_smem(k) -> int:
    """The shared memory (bytes) of K11's kernel
    (`tan_fwd_smem_bytes` in csrc/tangent_common.cuh): two activation
    buffers of the four streams, and per point x, the sdf and the
    gradient."""
    return 2 * 2 * _STREAMS * _POINTS * k.lda + 4 * _POINTS * (3 + 1 + 3)


def bwd_stages(icfg: mlp.ImplicitNetConfig, ws, bs) -> rev.RevStages:
    """K12's pack: K6's (`rev.RevStages`), for a net with no encoding too
    (run as frequency count 0)."""
    return rev.RevStages(icfg, ws, bs, embed_none=True)


# ---- kernels ----------------------------------------------------------------

def check_points(k: SdfGradLayout, x: torch.Tensor, name: str):
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors; the plain "
                         "version runs on the CPU")
    mma_pack.check_input(x, "x", cols=3)
    if k.fwd.weights.device != x.device:
        raise ValueError(f"{name}: the weights are not on the points' "
                         "device")


def sdf_grad_fwd(k: SdfGradLayout, x: torch.Tensor):
    """K11: (out (N, 1 + F), grad (N, 3)), unclamped."""
    global launches
    check_points(k, x, "sdf_grad_fwd")
    n = x.shape[0]
    out = torch.empty((n, k.out_cols), dtype=torch.float32, device=x.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n == 0:
        return out, grad
    err = build.load_library().i2sdf_sdf_grad_fwd(
        x.data_ptr(), n, k.fwd.weights.data_ptr(), k.fwd.biases.data_ptr(),
        k.fwd.plan.ctypes.data, k.fwd.n_layers, k.mx, k.lda, k.out_cols,
        out.data_ptr(), grad.data_ptr(), mma_pack.stream_of(x))
    build.check(err, "sdf_grad_fwd")
    launches += 1
    return out, grad


def sdf_grad_bwd(kr: rev.RevStages, x: torch.Tensor, c_out: torch.Tensor,
                 c_g: torch.Tensor):
    """K12: the gradients of <c_out, out> + <c_g, grad> (unclamped
    outputs) with respect to the materialized weights and biases, as
    (dws, dbs) lists of f32 tensors in the net's shapes: K6 on K6's pack
    (`bwd_stages`), through K12's own C entry."""
    global bwd_launches
    grads, launched = rev.bwd_launch("i2sdf_sdf_grad_bwd", "sdf_grad_bwd",
                                     kr, x, c_out, c_g)
    bwd_launches += launched
    return grads


class SdfGradOp(torch.autograd.Function):
    """The op on the card: K11 forward on its layout, K12 backward on K6's
    pack, both packed once in the forward.

    apply(icfg, x, *ws, *bs) -> (out, grad), unclamped. Gradients flow to
    the weights and biases only; x is a constant."""

    @staticmethod
    def forward(ctx, icfg, x, *flat):
        n = len(flat) // 2
        out, grad = sdf_grad_fwd(SdfGradLayout(icfg, flat[:n], flat[n:]), x)
        ctx.stages = bwd_stages(icfg, flat[:n], flat[n:])
        ctx.save_for_backward(x)
        return out, grad

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, c_out, c_g):
        (x,) = ctx.saved_tensors
        dws, dbs = sdf_grad_bwd(ctx.stages, x, c_out.float().contiguous(),
                                c_g.float().contiguous())
        return (None, None, *dws, *dbs)


def sdf_outputs_fused_grad(implicit: mlp.ImplicitNet, x: torch.Tensor,
                           plain: bool = False):
    """(sdf (N, 1), features (N, F), grad (N, 3)) of the bounding-sphere
    clamped SDF, differentiable with respect to the net's parameters,
    through the gradient too. CPU tensors take the plain version; CUDA
    tensors launch K11 now and K12 in the backward (or raise).
    `plain=True` takes the plain version on any device (to hold the
    kernels against it on the card)."""
    cfg = implicit.cfg
    lins = implicit.layers()
    ws, bs = [l.weight() for l in lins], [l.b for l in lins]
    if x.is_cuda and not plain:
        out, grad = SdfGradOp.apply(cfg, x, *ws, *bs)
    else:
        out, grad = sdf_grad_plain(cfg, ws, bs, x)
    sdf, grad = render_core._sphere_clamp(cfg, x, out[:, :1], grad)
    return sdf, out[:, 1:], grad
