"""K3 `render_core_fwd`: SDF, spatial gradient and radiance at points.

Replaces the forward of `i2sdf_tpu/ops/pallas/fused_train.py:449
get_render_core_op` (via `render_core_fused`, `:707`), the eval forward of
the render. The CUDA kernel is `csrc/render_core.cu` (its header says what
bounds it and how it is built); `render_core_plain` is the same function
in plain PyTorch (f32, the gradient by autograd), which the CPU path and
the tests use. The bounding-sphere clamp is applied outside the kernel,
as `fused_train.py:771-777` does.
"""

from __future__ import annotations

import torch

from ...models import mlp
from . import build, mma_pack

launches = 0  # kernel launches since the last reset_launch_counts()

_ROWS = 32               # points per block (csrc/render_core.cu kRows)
_MAX_WIDTH = 320         # 8 warps x 5 tiles x 8 columns
_MAX_SMEM = 232448       # bytes a block may use on the H100
_PLAIN_CHUNK = 1 << 17


class _KernelLayout:
    def __init__(self, implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet):
        icfg, rcfg = implicit.cfg, rendering.cfg
        mma_pack.check_sdf_net(icfg)
        F = icfg.feature_vector_size
        if icfg.d_out != 1 or F % 2:
            raise ValueError("render_core_fwd: needs d_out 1 and an even "
                             "feature width")
        if rcfg.embed_type != "positional" or rcfg.d_in != 3:
            raise ValueError("render_core_fwd: the radiance net takes the "
                             "positional view encoding")
        dims = icfg.layer_dims()
        d0 = dims[0]
        n = implicit.n_layers
        # forward: output layer as [features | sdf]
        fwd_layers = mma_pack.sdf_chain(implicit,
                                        last_cols=list(range(1, F + 1)) + [0])
        self.fwd = mma_pack.pack_chain(fwd_layers)
        # reverse sweep: transposed hidden layers, last hidden first
        lins = implicit.layers()
        rev = []
        for l in range(n - 2, -1, -1):
            w_t = lins[l].weight().detach().float().t()
            skip = l in icfg.skip_in
            if l == 0:
                real, col, flags = 0, 0, 0
            elif skip:
                real, col, flags = dims[l] - d0, dims[l] - d0, mma_pack.SCALE
            else:
                real, col, flags = dims[l], mma_pack.NO_COL, 0
            rev.append(dict(w=w_t, b=None, real=real, col=col, flags=flags))
        self.rev = mma_pack.pack_chain(rev)
        w_last = lins[-1].weight().detach().float()[:, 0]
        k0 = int(self.rev.plan[0, 0])
        col0 = torch.zeros(k0, dtype=torch.float32, device=w_last.device)
        col0[:w_last.shape[0]] = w_last.to(torch.bfloat16).float()
        self.wsdf_col = col0
        # radiance: first layer rows reordered [features | PE(view)]
        rl = rendering.layers()
        vdim = rcfg.layer_dims()[0] - F
        perm = list(range(vdim, vdim + F)) + list(range(vdim))
        rad = []
        for l, lin in enumerate(rl):
            w = lin.weight().detach().float()
            rad.append(dict(w=w[perm] if l == 0 else w,
                            b=lin.b.detach().float()))
        self.rad = mma_pack.pack_chain(rad)
        widest = max(self.fwd.max_width, self.rev.max_width,
                     self.rad.max_width)
        if widest > _MAX_WIDTH:
            raise ValueError(f"render_core_fwd: layer width above "
                             f"{_MAX_WIDTH}")
        self.lda = mma_pack.row_stride(widest)
        self.ldd = mma_pack.row_stride(int(self.fwd.plan[:-1, 1].max()))
        self.ldg = mma_pack.round_up(d0, 8)
        smem = (2 * (2 * _ROWS * self.lda + (n - 1) * _ROWS * self.ldd)
                + 4 * _ROWS * (7 + self.ldg))
        if smem > _MAX_SMEM:
            raise ValueError(f"render_core_fwd: needs {smem} bytes of shared "
                             "memory")
        self.mx, self.md = icfg.multires, rcfg.multires


class RenderCorePack:
    """Both nets, plus their kernel layout when they live on the card."""

    def __init__(self, implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet):
        self.implicit, self.rendering = implicit, rendering
        self.kernel = (_KernelLayout(implicit, rendering)
                       if next(implicit.parameters()).is_cuda else None)


def render_core_plain(implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet,
                      x: torch.Tensor, dirs: torch.Tensor):
    """(sdf (N, 1), grad (N, 3), rgb (N, 3)) in f32 (chunked)."""
    outs = []
    for xc, dc in zip(x.split(_PLAIN_CHUNK), dirs.split(_PLAIN_CHUNK)):
        sdf, feat, grad = mlp.sdf_outputs(implicit, xc)
        with torch.no_grad():
            outs.append((sdf, grad, rendering(dc, feat)))
    if not outs:
        z = x.new_zeros((0, 1))
        return z, x.new_zeros((0, 3)), x.new_zeros((0, 3))
    return tuple(torch.cat(o) for o in zip(*outs))


def render_core_fwd(p: RenderCorePack, x: torch.Tensor, dirs: torch.Tensor):
    """(sdf (N, 1), grad (N, 3), rgb (N, 3)) at points x along unit dirs.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    global launches
    if not x.is_cuda:
        return render_core_plain(p.implicit, p.rendering, x, dirs)
    k = p.kernel
    if k is None:
        raise ValueError("render_core_fwd: the nets' weights are not on the "
                         "card")
    mma_pack.check_input(x, "x", cols=3)
    mma_pack.check_input(dirs, "dirs", cols=3)
    if dirs.shape != x.shape or dirs.device != x.device:
        raise ValueError("render_core_fwd: x and dirs differ in shape or "
                         "device")
    n = x.shape[0]
    sdf = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    err = lib.i2sdf_render_core_fwd(
        x.data_ptr(), dirs.data_ptr(), n,
        k.fwd.weights.data_ptr(), k.fwd.biases.data_ptr(),
        k.fwd.plan.ctypes.data, k.fwd.n_layers,
        k.rev.weights.data_ptr(), k.rev.plan.ctypes.data, k.rev.n_layers,
        k.wsdf_col.data_ptr(),
        k.rad.weights.data_ptr(), k.rad.biases.data_ptr(),
        k.rad.plan.ctypes.data, k.rad.n_layers,
        k.mx, k.md, k.lda, k.ldd, k.ldg,
        sdf.data_ptr(), grad.data_ptr(), rgb.data_ptr(),
        mma_pack.stream_of(x))
    build.check(err, "render_core_fwd")
    launches += 1
    icfg = p.implicit.cfg
    if icfg.sdf_bounding_sphere > 0.0:
        norm = torch.linalg.norm(x, dim=-1, keepdim=True)
        sphere = icfg.sphere_scale * (icfg.sdf_bounding_sphere - norm)
        sphere_grad = -icfg.sphere_scale * x / torch.clamp(norm, min=1e-12)
        grad = torch.where(sphere < sdf, sphere_grad, grad)
        sdf = torch.minimum(sdf, sphere)
    return sdf, grad, rgb
