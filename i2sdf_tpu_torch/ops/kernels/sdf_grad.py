"""K11 `sdf_grad_fwd` and K12 `sdf_grad_bwd`: the SDF net's outputs and the
spatial gradient of its sdf at points, by forward-mode tangent streams, and
the backward of the same function, through that gradient too.

Replaces `i2sdf_tpu/ops/pallas/fused_grad.py:250 get_sdf_outputs_op`: its
forward (pallas_call at `:277`) is K11 (`csrc/sdf_grad_fwd.cu`), its
backward (`:323`) is K12 (`csrc/sdf_grad_bwd.cu`). The op computes what
`get_rev_op` (K5/K6, `rev.py`) computes (`fused_rev.py:215-219`), and
its forward is K10's function without the bounding-sphere clamp. So K11
is K10's kernel (K3's wgmma tangent form on the SDF net, the three
tangents d/dx_k riding through the net beside the activations) launched
with sphere radius 0, and K12 is K6's kernels (its wgmma sweeps,
products and sums); each under its own C entry and launch count, both on
one pack, K6's `rev.RevStages`, whose SDF stage chain is K10's
(`sdf_outputs.OutputStages`) byte for byte. On the same inputs K11's
output is K10's at sphere 0 and K12's gradients are K6's, to the bit.
The op takes K10's and K6's nets: layers up to 256 wide, a feature width
that is a multiple of 8 up to 256, up to 10 encoding frequencies, 1 to
14 hidden layers (`sdf_outputs.check_stages`; the first design took
layers up to 320 wide, but K12's pack never did). Each CUDA source's
header says what bounds it.

* `embed_tangents` and `sdf_tangents`: the tangent sweep in plain f32
  PyTorch, differentiable with respect to the weights (autograd through
  it gives the second order). The embedding's tangents are arguments, so
  that a check can feed a faulty layout through the same sweep.
* `bwd_stages(icfg, ws, bs)`: the op's one pack, K6's `rev.RevStages`
  (a net with no encoding too, run as frequency count 0): K11 reads its
  `.sdf` chain, K12 all of it.
* `sdf_grad_fwd(k, x)` -> (out (N, 1 + F), grad (N, 3)) and
  `sdf_grad_bwd(k, x, c_out, c_g)` -> (dws, dbs): the launches, CUDA
  tensors only.
* `sdf_grad_plain(icfg, ws, bs, x)`: the same function in plain f32
  PyTorch, the gradient by autograd with `create_graph` (`rev.rev_plain`).
  The CPU path and the tests use it; on the card it only serves as the
  yardstick the kernels are held to.
* `SdfGradOp`: the `torch.autograd.Function` on the card, K11 forward,
  K12 backward, on the pack the forward builds once, no gradient to x
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
from . import build, mma_pack, render_core, rev, sdf_outputs

launches = 0      # K11 launches since the last reset_launch_counts()
bwd_launches = 0  # K12 launches since the last reset_launch_counts()


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

def bwd_stages(icfg: mlp.ImplicitNetConfig, ws, bs) -> rev.RevStages:
    """The op's one pack: K6's (`rev.RevStages`), for a net with no
    encoding too (run as frequency count 0). K11 launches on its `.sdf`
    chain (K10's, `sdf_outputs.OutputStages`' bits), K12 on all of it."""
    return rev.RevStages(icfg, ws, bs, embed_none=True)


# ---- kernels ----------------------------------------------------------------

def sdf_grad_fwd(k: rev.RevStages, x: torch.Tensor):
    """K11: (out (N, 1 + F), grad (N, 3)), unclamped: K10's kernel on the
    pack's `.sdf` chain at sphere radius 0, through K11's own entry."""
    global launches
    sdf_outputs.check_points(k, x, "sdf_grad_fwd")
    sdf_outputs.check_stages(k, "sdf_grad_fwd")
    n = x.shape[0]
    out = torch.empty((n, k.F + 1), dtype=torch.float32, device=x.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    if n:
        err = build.load_library().i2sdf_sdf_grad_fwd(
            x.data_ptr(), n, k.sdf.weights.data_ptr(),
            k.sdf.biases.data_ptr(), k.sdf.plan.ctypes.data, k.sdf.n_layers,
            k.mx, k.F, out.data_ptr(), grad.data_ptr(),
            mma_pack.stream_of(x))
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
    """The op on the card: K11 forward, K12 backward, both on the one
    pack (`bwd_stages`) the forward builds.

    apply(icfg, x, *ws, *bs) -> (out, grad), unclamped. Gradients flow to
    the weights and biases only; x is a constant."""

    @staticmethod
    def forward(ctx, icfg, x, *flat):
        n = len(flat) // 2
        ctx.stages = bwd_stages(icfg, flat[:n], flat[n:])
        out, grad = sdf_grad_fwd(ctx.stages, x)
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
