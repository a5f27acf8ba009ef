"""K3 `render_core_fwd` and K4 `render_core_bwd`: SDF, spatial gradient and
radiance at points (and, with a light head, the light mask), and the
backward of the same function.

Replaces `i2sdf_tpu/ops/pallas/fused_train.py:449 get_render_core_op`:
its forward (pallas_call at `:555`) is K3 (`csrc/render_core.cu`, on
`csrc/wgmma_layer.cuh`, the nets as stage images: `CoreStages`), its
backward (`:609`, `_make_bwd_kernel` at `:267-446`) is K4
(`csrc/render_core_bwd.cu`, on the same primitive: K3's `CoreStages` and
the transposed chains of `K4Stages`; its scratch, ring table and
weight-gradient jobs: `K4Plan`). Each CUDA source's header says what
bounds it and how it is built.

The light head of the light-mask config (the `lcfg` / `detach_light`
branch of the TPU op: `_light_forward` at `:173-195`, the forward at
`:252-256`, the backward at `:324-348`) runs inside both kernels: the
light MLP on relu(features), a sigmoid mask (N, 1) beside sdf, grad and
rgb. K3 and K4 with the light head are their own kernel instantiations
(`kLight` in `csrc/render_core.cu` and `csrc/common.cuh`), counted apart:
`render_core_fwd_light`
and `render_core_bwd_light`. The light loss reaches the light net; with
`detach_light` off, its feature cotangent joins the SDF's through
relu'(features) (`fused_train.py:345-348`).

The idr-mode radiance net (VolSDF's DTU and IDR's, `rcfg.mode == "idr"`,
`d_in` 9: the TPU op's `idr` branch, `_rad_input` at `:199-218`, the
backward's gradient cotangent at `:355-366`, the row permutation at
`:740-748`) takes [features | PE(view) | pts | grad] in the kernels'
order, `grad` being the unclamped spatial gradient: K3 writes the raw xyz
and its gradient as bf16 into the radiance tile after PE(view); K4 takes
the gradient K3 gave the same points (`RenderCoreTrain` keeps it) for
the radiance forward, and adds the radiance input's cotangent on the
gradient's columns to the external one before the second-order sweeps.
K3-idr is its own instantiation (`kIdr`), K4-idr K4's sweep on its
branch for a given gradient (`gin`); both are counted apart:
`render_core_fwd_idr` and `render_core_bwd_idr`. The light head beside
idr (the TPU op's `lcfg` with `idr`, `fused_train.py:221-265,267-446`) is
K3's `kLight` x `kIdr` instantiation and K4's light sweep on its idr
branch, counted as `render_core_fwd_light_idr` and
`render_core_bwd_light_idr`: K3's light input sits in tile 1 and the idr
columns in tile 0; K4 runs the light head before it writes the idr
columns into T, and the light's feature cotangent (coupled, staged in
the scratch) and idr's gradient cotangent (summed into c_grad in shared
memory) join at different places.

* `render_core_fwd(pack, x, dirs)`: the eval forward (no gradient).
* `render_core_train(nets, x, dirs)`: the training op, differentiable
  with respect to every net's parameters, through the spatial gradient
  too. On the card it is `RenderCoreTrain`, a `torch.autograd.Function`
  whose forward launches K3 and whose backward launches K4; it takes the
  *materialized* weights (weight norm applied outside by autograd) and
  saves its inputs and K3's pack, as `op_fwd` saves its inputs
  (`fused_train.py:647-650`).
* `render_core_plain` / `render_core_train_plain`: the same functions in
  plain f32 PyTorch (the gradient by autograd, with `create_graph` for
  training; the light head as `_ref_light` in
  `tests/test_pallas_train.py:139-148`). The CPU path and the tests use
  them; on the card they only serve as the yardstick the kernels are
  held to.

The bounding-sphere clamp is applied outside the kernels, as
`fused_train.py:771-777` does. K5 and K6 (and K12, which is K6) run K4's
sweeps on K4's packs (`core_sdf_layers`, `t_sdf_layers`;
`rev.RevStages`), K6 on K4's plan (`K4Plan`), K5 on its own table of the
same items (`rev.K5Plan`); K10 (and K11, which is K10 at sphere radius
0) runs K3's tangent form on K3's SDF chain (`core_sdf_layers`;
`sdf_outputs.OutputStages`, and `rev.RevStages.sdf` for K11).
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
idr_launches = 0        # K3 with the idr radiance input
idr_bwd_launches = 0    # K4 with the idr radiance input
light_idr_launches = 0      # K3 with the light head and the idr input
light_idr_bwd_launches = 0  # K4 with the light head and the idr input

_K3_WIDTH = 256          # K3: a tile's four 64-column chunks, wgmma's N
_K3_RAD_K = 320          # K3 and K4: five chunks, the radiance input
_MAX_LAYERS = 16         # K3, K4: a `Plan`'s rows (kMaxLayers)
_MAX_SPLITS = 32         # point-range splits of the weight-gradient sums
_PLAIN_CHUNK = 1 << 17
_K4_POINTS = 64          # K4: points a block (kPts)
_K4_REG_LAYERS = 16      # K4: layer slots of a region kind (kRegLayers)
_K4_JOBS = 24            # K4: weight gradients (kMaxWJobs)
_CHUNK = 64 * 128        # bytes of a 64-row, 64-column bf16 chunk


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


def _rad_perm(vdim: int, F: int, idr: bool = False) -> list:
    """Kernel row order of the radiance input layer: [features | PE(view)]
    (the nets' order is [PE(view) | features]); in idr mode [features |
    PE(view) | pts | grad] (the nets' order is [pts | PE(view) | normals |
    features], `fused_train.py:740-748`)."""
    if not idr:
        return list(range(vdim, vdim + F)) + list(range(vdim))
    g = 3 + vdim
    return (list(range(g + 3, g + 3 + F)) + list(range(3, g))
            + list(range(3)) + list(range(g, g + 3)))


def check_radiance_net(rcfg: mlp.RenderingNetConfig) -> None:
    """The radiance nets the kernels run (`supports_render_core`,
    `fused_train.py:683-704`): the positional view encoding, three raw
    inputs in nerf mode, nine in idr mode with no point encoding (with or
    without a light head beside it)."""
    idr = rcfg.mode == "idr"
    if (rcfg.embed_type != "positional" or rcfg.d_in != (9 if idr else 3)
            or rcfg.point_multires() or rcfg.d_out != 3):
        raise ValueError("render_core: the radiance net takes the "
                         "positional view encoding (and in idr mode the raw "
                         "points and the gradient, no point encoding)")


def sdf_layers(icfg: mlp.ImplicitNetConfig, ws: list, bs: list,
               embed_none: bool = False) -> list:
    """The SDF net's layers for a packer (`mma_pack.pack_stage_chain`):
    weights, biases, the skip's flags and column."""
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
    return layers


def core_sdf_layers(icfg: mlp.ImplicitNetConfig, ws: list, bs: list,
                    embed_none: bool = False) -> list:
    """`CoreStages.sdf`'s layers (K3's, K4's, K5's, K6's and K10's SDF
    chain) from the net's (in, out) weights and biases: the hidden layers,
    then the output layer as the sdf alone and then the features
    (`_sdf_perm`); `embed_none` also takes a net with no encoding (K10's
    and K12's, run as frequency count 0)."""
    F = icfg.feature_vector_size
    layers = sdf_layers(icfg, ws, bs, embed_none)
    perm = _sdf_perm(F)
    w_out, b_out = ws[-1][:, perm], bs[-1][perm]
    layers[-1:] = [dict(w=w_out[:, F:], b=b_out[F:]),
                   dict(w=w_out[:, :F], b=b_out[:F])]
    return layers


def t_sdf_layers(icfg: mlp.ImplicitNetConfig, ws: list,
                 first: bool = False) -> list:
    """`K4Stages`' transposed SDF layers n-1 .. 1 (K4's and K6's) from the
    net's (in, out) weights, the output layer's input rows as [features |
    sdf] (`_sdf_perm`); with `first` also layer 0 (K5's last product:
    all its columns are the encoding's, `real` 0 and `col` 0)."""
    dims = icfg.layer_dims()
    d0, n = dims[0], len(dims) - 1
    ws = ws[:-1] + [ws[-1][:, _sdf_perm(icfg.feature_vector_size)]]
    layers = []
    for l in range(n - 1, -1 if first else 0, -1):
        if l == 0:
            real, col, flags = 0, 0, 0
        elif l in icfg.skip_in:
            real, col, flags = dims[l] - d0, dims[l] - d0, mma_pack.SCALE
        else:
            real, col, flags = dims[l], mma_pack.NO_COL, 0
        layers.append(dict(w=ws[l].t(), real=real, col=col, flags=flags))
    return layers


class CoreStages:
    """K3's nets as stage images (`mma_pack.pack_stage_chain`), from
    materialized weights:

    * `sdf`: the SDF net's hidden layers, then its output layer as two
      products in the order the kernel takes them: the sdf alone (an
      N = 8 product whose tangent rows give the gradient), then the
      features (the first F columns of [features | sdf], `_sdf_perm`);
    * `rad`: the radiance net, its first layer's rows as [features |
      PE(view)], in idr mode [features | PE(view) | pts | grad]
      (`_rad_perm`);
    * `light`: with a light head (`lcfg`), the light net on relu(features)
      (`n_light` layers; None and 0 without)."""

    def __init__(self, icfg: mlp.ImplicitNetConfig,
                 rcfg: mlp.RenderingNetConfig, w: CoreWeights,
                 lcfg: mlp.ImplicitNetConfig | None = None):
        F = icfg.feature_vector_size
        if icfg.d_out != 1 or F % 2:
            raise ValueError("render_core: needs d_out 1 and an even "
                             "feature width")
        check_radiance_net(rcfg)
        self.sdf = mma_pack.pack_stage_chain(core_sdf_layers(
            icfg, [t.detach().float() for t in w.ws_sdf],
            [t.detach().float() for t in w.bs_sdf]))
        self.idr = rcfg.mode == "idr"
        self.vdim, self.rad_in = rcfg.view_dim(), rcfg.layer_dims()[0]
        wr = [t.detach().float() for t in w.ws_rad]
        br = [t.detach().float() for t in w.bs_rad]
        wr[0] = wr[0][_rad_perm(self.vdim, F, self.idr)]
        self.rad = mma_pack.pack_stage_chain(
            [dict(w=a, b=b) for a, b in zip(wr, br)])
        self.light, self.n_light = None, n_layers(lcfg)
        chains = [self.sdf, self.rad]
        if lcfg is not None:
            check_light_net(icfg, lcfg)
            self.light = mma_pack.pack_stage_chain(
                [dict(w=a.detach().float(), b=b.detach().float())
                 for a, b in zip(w.ws_l, w.bs_l)])
            chains.append(self.light)
        rad = self.rad.plan
        widest = max([int(self.sdf.plan[:, :2].max()), int(rad[:, 1].max()),
                      int(rad[1:, 0].max(initial=0))]
                     + [int(c.plan[:, :2].max()) for c in chains[2:]])
        if (widest > _K3_WIDTH or F > _K3_WIDTH
                or int(rad[0, 0]) > _K3_RAD_K):
            raise ValueError(f"render_core_fwd: a layer wider than "
                             f"{_K3_WIDTH} (radiance input {_K3_RAD_K})")
        if max(c.n_layers for c in chains) > _MAX_LAYERS:
            raise ValueError("render_core_fwd: too many layers")
        self.F, self.mx, self.md = F, icfg.multires, rcfg.multires


class RenderCorePack:
    """The nets (the light net too, if there is one), plus K3's layout when
    they live on the card (packed once, for eval)."""

    def __init__(self, implicit: mlp.ImplicitNet, rendering: mlp.RenderingNet,
                 light: mlp.ImplicitNet | None = None):
        self.implicit, self.rendering, self.light = implicit, rendering, light
        self.kernel = None
        if next(implicit.parameters()).is_cuda:
            with torch.no_grad():
                self.kernel = CoreStages(
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
    and `dirs` are constants. In idr mode the radiance net takes the
    points and this unclamped gradient, as the TPU kernel's `_rad_input`
    does (the XLA composition takes the clamped one; they differ only
    with a bounding sphere, which the renderer's nets never have)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = mlp.implicit_apply(icfg, w.ws_sdf, w.bs_sdf, xg)
        sdf, feat = out[:, :1], out[:, 1:]
        (grad,) = torch.autograd.grad(sdf, xg, torch.ones_like(sdf),
                                      create_graph=True)
        rgb = mlp.rendering_apply(rcfg, w.ws_rad, w.bs_rad, dirs, feat, x,
                                  grad)
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
    light net the light mask (N, 1). An idr-mode radiance net takes the
    unclamped gradient (`render_core_train_plain`, the light head beside
    it too)."""
    idr = rendering.cfg.mode == "idr"
    if idr:
        with torch.no_grad():
            w = CoreWeights.of(implicit, rendering, light)
    outs = []
    for xc, dc in zip(x.split(_PLAIN_CHUNK), dirs.split(_PLAIN_CHUNK)):
        if idr:
            with torch.no_grad():
                sdf, grad, *rest = render_core_train_plain(
                    implicit.cfg, rendering.cfg, w, xc, dc,
                    None if light is None else light.cfg)
                sdf, grad = _sphere_clamp(implicit.cfg, xc, sdf, grad)
                outs.append(tuple(t.detach() for t in (sdf, grad, *rest)))
            continue
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


def _light_args(k) -> tuple:
    """The light net's kernel arguments for K3 (null pointers without
    one)."""
    if not k.n_light:
        return None, None, None, 0
    return (k.light.weights.data_ptr(), k.light.biases.data_ptr(),
            k.light.plan.ctypes.data, k.n_light)


def _variant(k: CoreStages) -> str:
    """The suffix of a pack's launch counter and trace range: "",
    "_light", "_idr" or "_light_idr"."""
    return ("_light" if k.n_light else "") + ("_idr" if k.idr else "")


def _launch_fwd(k: CoreStages, x: torch.Tensor, dirs: torch.Tensor):
    global launches, light_launches, idr_launches, light_idr_launches
    _check_points(x, dirs, "render_core_fwd")
    if k.sdf.weights.device != x.device:
        raise ValueError("render_core_fwd: the weights are not on the "
                         "points' device")
    n = x.shape[0]
    sdf = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    lmask = (torch.empty((n, 1), dtype=torch.float32, device=x.device)
             if k.n_light else None)
    lib = build.load_library()
    with torch.profiler.record_function("render_core_fwd" + _variant(k)):
        err = lib.i2sdf_render_core_fwd(
            x.data_ptr(), dirs.data_ptr(), n,
            k.sdf.weights.data_ptr(), k.sdf.biases.data_ptr(),
            k.sdf.plan.ctypes.data, k.sdf.n_layers,
            k.rad.weights.data_ptr(), k.rad.biases.data_ptr(),
            k.rad.plan.ctypes.data, k.rad.n_layers, *_light_args(k),
            k.mx, k.md, k.F, int(k.idr),
            sdf.data_ptr(), grad.data_ptr(), rgb.data_ptr(),
            None if lmask is None else lmask.data_ptr(),
            mma_pack.stream_of(x))
    build.check(err, "render_core_fwd")
    if k.n_light and k.idr:
        light_idr_launches += 1
    elif k.n_light:
        light_launches += 1
    elif k.idr:
        idr_launches += 1
    else:
        launches += 1
    return (sdf, grad, rgb, lmask) if k.n_light else (sdf, grad, rgb)


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


class K4Stages:
    """What K4 needs beside K3's `CoreStages`: the transposed products' stage
    images, in one blob (`t`, `mma_pack.pack_stage_chain` of W_l^T, so
    each stage holds W's rows over a 64-deep chunk of the product's
    reduction, a layer's output columns), and the sdf column of the SDF
    output layer:

    * `t.plan[:n_sdf - 1]` (`tsdf`): the SDF net's layers n-1 .. 1, the
      output layer's input rows as [features | sdf] (`_sdf_perm`); each
      row's `real` is the width that continues down the net (the hidden
      part before a skip's encoding), `col` where the encoding starts
      (a skip's) and SCALE marks a skip's 1/sqrt(2) (`t_sdf_layers`);
    * then (`trad`) the radiance net's layers n_r-1 .. 0, layer 0's output
      cut to the F feature columns;
    * then (`tlight`) the light net's layers n_l-1 .. 0 (none without a
      light head);
    * `wsdf`: W_{n-1}[:, sdf] rounded to bf16 (f32, zero-padded), d sdf /
      d h of the last hidden layer;
    * `wgr` (idr mode): the radiance input layer's three gradient rows
      rounded to bf16 (3, N_0 padded to 64, f32), against which K4 takes
      the radiance input's cotangent on the gradient's columns (None in
      nerf mode)."""

    def __init__(self, icfg: mlp.ImplicitNetConfig,
                 rcfg: mlp.RenderingNetConfig, w: CoreWeights,
                 lcfg: mlp.ImplicitNetConfig | None = None):
        F = icfg.feature_vector_size
        dims, rdims = icfg.layer_dims(), rcfg.layer_dims()
        n = len(dims) - 1
        ws = [t.detach().float() for t in w.ws_sdf]
        layers = t_sdf_layers(icfg, ws)
        wr = [t.detach().float() for t in w.ws_rad]
        idr = rcfg.mode == "idr"
        vdim = rcfg.view_dim()
        wr[0] = wr[0][_rad_perm(vdim, F, idr)]
        self.wgr = None
        if idr:
            n0 = wr[0].shape[1]
            width = mma_pack.round_up(mma_pack.wg_width(n0), 64)
            self.wgr = torch.zeros((3, width), dtype=torch.float32,
                                   device=wr[0].device)
            self.wgr[:, :n0] = wr[0][F + vdim + 3:F + vdim + 6].to(
                torch.bfloat16).float()
        wr[0] = wr[0][:F]
        nr = len(wr)
        layers += [dict(w=wr[l].t(), real=F if l == 0 else rdims[l])
                   for l in range(nr - 1, -1, -1)]
        wl = [t.detach().float() for t in w.ws_l]
        layers += [dict(w=wl[l].t()) for l in range(len(wl) - 1, -1, -1)]
        self.t = mma_pack.pack_stage_chain(layers)
        self.n_sdf, self.n_rad, self.n_light = n, nr, len(wl)
        self.tsdf = np.ascontiguousarray(self.t.plan[:n - 1])
        self.trad = np.ascontiguousarray(self.t.plan[n - 1:n - 1 + nr])
        self.tlight = np.ascontiguousarray(self.t.plan[n - 1 + nr:])
        K = ws[-1].shape[0]
        self.wsdf = torch.zeros(mma_pack.round_up(K, 64) + 8,
                                dtype=torch.float32, device=ws[0].device)
        self.wsdf[:K] = ws[-1][:, 0].to(torch.bfloat16).float()
        if int(self.t.plan[:, 1].max()) > _K3_WIDTH or (
                int(self.t.plan[:, 0].max()) > _K3_RAD_K):
            raise ValueError("render_core_bwd: a layer wider than "
                             f"{_K3_WIDTH}")
        if F % 8:
            raise ValueError("render_core_bwd: needs a feature width that "
                             "is a multiple of 8")


def _chunks(cols: int) -> int:
    return -(-int(cols) // 64)


# ring table items (`ItemKind`, `Bases` in csrc/render_core_bwd.cu)
_LOAD, _STAGE, _WAIT = 0, 1, 2
_B_SCRATCH, _B_SDF, _B_RAD, _B_LIGHT, _B_T = range(5)
# region kinds (`RegionKind`)
(REG_X, REG_DZ, REG_DA, REG_R, REG_Q, REG_AH, REG_DZX, REG_RX, REG_RDZ,
 REG_LX, REG_LDZ, REG_LS, REG_CLG) = range(13)
_REG_KINDS = 13
_SLOT = 4 * _CHUNK       # a ring slot: 32 KB


def weight_items(base: int, row) -> list:
    """A layer's ring-table items (`K4Plan.script`'s format): a load of
    each 64-deep chunk's stage image from the blob at `base`."""
    K, N, woff = int(row[0]), int(row[1]), int(row[3])
    return [(_LOAD | base << 8, 2 * woff + c * N * 128, 0, N * 128)
            for c in range(_chunks(K))]


class K4Plan:
    """K4's scratch at n points (bytes), the ring table its producer walks
    and its weight-gradient jobs, from K3's `CoreStages` (`st`) and
    `K4Stages` (`t`); `coupled`: the light head with `detach_light` off.
    All of it depends only on the shapes (`plan_for` caches it). K6's plan
    is the same with `rev.RevStages` as both packs: no radiance or light
    layers, and the forward recompute stops at the output layer's input.

    * `regions[kind][l]` = (byte offset of block 0's tile, bytes a
      block): each 64-point block's tiles as the sweep stores them, 64-row
      chunks of 64 columns in the 128-byte swizzle (8 KB each; the f32
      `REG_AH` and `REG_CLG` tiles two 32 KB slots in accumulator order).
      The operands of the weight gradients: `REG_X`, `REG_DZ`, `REG_DA`,
      `REG_R` per SDF layer, `REG_RX`, `REG_RDZ` per radiance layer,
      `REG_LX`, `REG_LDZ` per light layer; the stash: `REG_Q` (q_l),
      `REG_AH` (ah_l, f32), `REG_DZX` (dz_extra_l), `REG_LS` (a hidden
      light layer's s), `REG_CLG` (the light's gated feature cotangent).
      Then every block's bias-gradient row (`dbpart`, `tb` f32 columns;
      weight gradient p's at `db[p]`), and 32 KB of slack that the
      products' 256-column B reads may run into.
    * `script`: (items, 4) int64, the ring's items in the order the
      consumers take them (`i2sdf_render_core_bwd`'s sweeps): [kind |
      base << 8, byte offset, bytes a block, bytes]; a load (weight
      stages from a chain's blob, a stash tile from the scratch), a
      staging slot handed out empty, or a wait until the consumers have
      completed that many sweeps' stores.
    * `jobs`: (p, 18) int64 per weight gradient, `WJob`'s fields: the
      operand pairs' regions, the partials' f32 offset in `ws32`, the
      pairs, K, N (the weight in kernel order), A's chunks, the blocks,
      blocks a split, splits, the output's offset in `out`; `dims` its
      (K, N)."""

    def __init__(self, st: CoreStages, t: K4Stages, n: int, coupled: bool):
        self.blocks = B = -(-max(n, 1) // _K4_POINTS)
        fwd, rad = st.sdf.plan, _rad_plan(st)
        light = st.light.plan if st.n_light else np.zeros((0, 8), np.int32)
        ns, nr, nl = t.n_sdf, t.n_rad, t.n_light
        out_k = int(t.tsdf[0, 0])
        # the weights' (K, N) in kernel order and their A, B chunks
        Ks = [int(v) for v in fwd[:ns - 1, 0]] + [int(fwd[ns, 0])]
        Ns = [int(v) for v in fwd[:ns - 1, 1]] + [out_k]
        self.scratch_bytes = 0
        self.regions = [[(0, 0)] * _K4_REG_LAYERS for _ in range(_REG_KINDS)]

        def take(kind, l, chunks):
            self.regions[kind][l] = (self.scratch_bytes, chunks * _CHUNK)
            self.scratch_bytes += B * chunks * _CHUNK

        for l in range(ns):
            take(REG_X, l, _chunks(Ks[l]))
            take(REG_DZ, l, _chunks(Ns[l]))
            take(REG_DA, l, _chunks(Ks[l]))
            take(REG_R, l, _chunks(Ns[l]))
        for l in range(ns - 1):
            take(REG_Q, l, _chunks(Ns[l]))
            take(REG_DZX, l, _chunks(Ns[l]))
            if l:
                take(REG_AH, l, 8)
        for l in range(nr):
            take(REG_RX, l, _chunks(rad[l, 0]))
            take(REG_RDZ, l, _chunks(rad[l, 1]))
        for l in range(nl):
            take(REG_LX, l, _chunks(light[l, 0]))
            take(REG_LDZ, l, _chunks(light[l, 1]))
            if l < nl - 1:
                take(REG_LS, l, _chunks(light[l, 1]))
        if coupled:
            take(REG_CLG, 0, 8)
        # the weight gradients: SDF (output layer [features | sdf]),
        # radiance (layer 0's rows [features | PE(view)]), light
        real_n = ([int(v) for v in fwd[:ns - 1, 2]] + [st.F + 1]
                  + [int(v) for v in rad[:, 2]] + [int(v) for v in light[:, 2]])
        self.db = list(np.cumsum([0] + real_n)[:-1].astype(int))
        self.tb = int(sum(real_n))
        self.dbpart = self.scratch_bytes
        self.scratch_bytes += mma_pack.round_up(B * self.tb * 4, 1024)
        self.scratch_bytes += _SLOT
        self.script = self._script(st, t, coupled)
        self.jobs, self.dims, self.n32, self.out = self._jobs(st, t, real_n)
        self.out_db = int(sum(k * n for k, n in self.dims))
        self.n_out = self.out_db + self.tb
        reg = np.zeros(_REG_KINDS * _K4_REG_LAYERS * 2 + 2 + len(real_n),
                       np.int64)
        for kind in range(_REG_KINDS):
            for l, (off, stride) in enumerate(self.regions[kind]):
                reg[2 * (kind * _K4_REG_LAYERS + l):][:2] = (off, stride)
        o = _REG_KINDS * _K4_REG_LAYERS * 2
        reg[o:o + 2] = (self.dbpart, self.tb)
        reg[o + 2:] = self.db
        self.reg = reg
        self.db_host = np.asarray([self.dbpart, self.tb, self.out_db],
                                  np.int64)
        self.dev = None   # (reg, script) on the card, at first launch

    def _script(self, st, t, coupled) -> np.ndarray:
        items, state = [], {"done": 0, "waited": 0}
        ns, nr, nl = t.n_sdf, t.n_rad, t.n_light
        fwd, rad = st.sdf.plan, _rad_plan(st)
        light = st.light.plan if nl else None

        def weights(base, row):
            items.extend(weight_items(base, row))

        def load(kind, l, nbytes, extra=0):
            if state["waited"] < state["done"]:
                items.append((_WAIT, state["done"], 0, 0))
                state["waited"] = state["done"]
            off, stride = self.regions[kind][l]
            items.append((_LOAD | _B_SCRATCH << 8, off + extra, stride,
                          nbytes))

        def stage():
            items.append((_STAGE, 0, 0, 0))

        def done():
            state["done"] += 1

        def tile(cols):
            return _chunks(cols) * _CHUNK

        for l in range(ns - 1):                      # 1. SDF forward
            weights(_B_SDF, fwd[l])
            stage()
        if nr:   # the features, for the radiance net (K6 has none)
            weights(_B_SDF, fwd[ns])
        done()
        if nl:                                       # 1b. the light head
            for l in range(nl):
                weights(_B_LIGHT, light[l])
                if l < nl - 1:
                    stage()
            done()
            for l in range(nl - 1, 0, -1):
                weights(_B_T, t.tlight[nl - 1 - l])
                load(REG_LS, l - 1, tile(light[l - 1, 1]))
            if coupled:
                weights(_B_T, t.tlight[nl - 1])
                load(REG_LX, 0, tile(light[0, 0]))
                stage()
                stage()
            done()
        if nr:
            for l in range(nr):                      # 2. radiance forward
                weights(_B_RAD, rad[l])
            done()
            for l in range(nr - 1, 0, -1):           # 3. radiance backward
                weights(_B_T, t.trad[nr - 1 - l])
                load(REG_RX, l, tile(rad[l, 0]))
            weights(_B_T, t.trad[nr - 1])
        if coupled:
            load(REG_CLG, 0, _SLOT)
            load(REG_CLG, 0, _SLOT, _SLOT)
        load(REG_Q, ns - 2, tile(fwd[ns - 2, 1]))    # 4. reverse sweep
        for l in range(ns - 2, 0, -1):
            weights(_B_T, t.tsdf[ns - 1 - l])
            load(REG_Q, l - 1, tile(fwd[l - 1, 1]))
            stage()
            stage()
        done()
        for l in range(ns - 1):                      # 5-6. upward sweep
            weights(_B_SDF, fwd[l])
            load(REG_Q, l, tile(fwd[l, 1]))
            if l < ns - 2:
                load(REG_AH, l + 1, _SLOT)
                load(REG_AH, l + 1, _SLOT, _SLOT)
            stage()
        done()
        for l in range(ns - 1, 0, -1):               # 7. downward sweep
            weights(_B_T, t.tsdf[ns - 1 - l])
            load(REG_Q, l - 1, tile(fwd[l - 1, 1]))
            load(REG_DZX, l - 1, tile(fwd[l - 1, 1]))
        return np.ascontiguousarray(np.asarray(items, np.int64))

    def _jobs(self, st, t, real_n):
        ns, nr, nl = t.n_sdf, t.n_rad, t.n_light
        fwd, rad = st.sdf.plan, _rad_plan(st)
        light = st.light.plan if nl else np.zeros((0, 8), np.int32)
        R, B = self.regions, self.blocks
        per = -(-B // min(_MAX_SPLITS, B))
        splits = -(-B // per)
        rows, dims, outs = [], [], []
        n32 = o = 0
        # the weights' K (their A side, padded to 16) in kernel order
        real_k = [int(v) for v in fwd[:ns - 1, 0]] + [int(fwd[ns, 0])]
        for p in range(ns + nr + nl):
            if p < ns:
                l = p
                pairs = [(R[REG_X][l], R[REG_DZ][l]),
                         (R[REG_DA][l], R[REG_R][l])]
                K = real_k[l]
            elif p < ns + nr:
                l = p - ns
                pairs = [(R[REG_RX][l], R[REG_RDZ][l])]
                K = int(rad[l, 0])
            else:
                l = p - ns - nr
                pairs = [(R[REG_LX][l], R[REG_LDZ][l])]
                K = int(light[l, 0])
            N = real_n[p]
            ka = pairs[0][0][1] // _CHUNK
            pairs = pairs + [pairs[0]] * (2 - len(pairs))
            row = ([pairs[0][0][0], pairs[1][0][0], pairs[0][0][1],
                    pairs[1][0][1], pairs[0][1][0], pairs[1][1][0],
                    pairs[0][1][1], pairs[1][1][1], n32,
                    2 if p < ns else 1, K, N, ka, B, per, splits, o, 0])
            rows.append(row)
            dims.append((K, N))
            outs.append(o)
            n32 += splits * K * N
            o += K * N
        if len(rows) > _K4_JOBS:
            raise ValueError("render_core_bwd: too many layers")
        return (np.ascontiguousarray(np.asarray(rows, np.int64)), dims,
                n32, outs)


def _rad_plan(st) -> np.ndarray:
    """The radiance chain's plan rows (none for K6's `rev.RevStages`)."""
    return np.zeros((0, 8), np.int32) if st.rad is None else st.rad.plan


_PLANS: dict = {}


def plan_for(st: CoreStages, t: K4Stages, n: int,
             coupled: bool) -> K4Plan:
    """K4's plan for these shapes, built once (K6's too: `rev.RevStages`
    as both packs)."""
    key = (st.sdf.plan.tobytes(), _rad_plan(st).tobytes(),
           None if st.light is None else st.light.plan.tobytes(),
           t.t.plan.tobytes(), -(-max(n, 1) // _K4_POINTS), coupled)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = K4Plan(st, t, n, coupled)
    return plan


def unpack_grads(st: CoreStages, t: K4Stages, out: torch.Tensor,
                 plan: K4Plan):
    """K4's flat output -> (dws_sdf, dbs_sdf, dws_rad, dbs_rad, dws_l,
    dbs_l) in the nets' own layouts (the light lists empty without a light
    head): padding cut (the real widths from the plans' rows), the SDF
    output layer's columns and the radiance input layer's rows put back in
    order (the gather's transpose, as autodiff of `fused_train.py:737-754`
    does)."""
    F, ns, nr = st.F, t.n_sdf, t.n_rad
    fwd, rad = st.sdf.plan, st.rad.plan
    shapes = []
    for l in range(ns):
        k = (3 + 6 * st.mx if l == 0 else int(fwd[l - 1, 2])
             + (3 + 6 * st.mx if fwd[l, 5] & mma_pack.SKIP_IN else 0))
        shapes.append((k, int(fwd[l, 2]) if l < ns - 1 else F + 1))
    shapes += [(st.rad_in if l == 0 else int(rad[l - 1, 2]), int(rad[l, 2]))
               for l in range(nr)]
    if t.n_light:
        lp = st.light.plan
        shapes += [(F if l == 0 else int(lp[l - 1, 2]), int(lp[l, 2]))
                   for l in range(t.n_light)]
    dws, dbs = [], []
    for p, (k, m) in enumerate(shapes):
        K, N = plan.dims[p]
        dws.append(out[plan.out[p]:plan.out[p] + K * N].view(K, N)[:k, :m])
        o = plan.out_db + plan.db[p]
        dbs.append(out[o:o + m])
    inv_sdf = np.argsort(_sdf_perm(F))
    dws[ns - 1] = dws[ns - 1][:, inv_sdf]
    dbs[ns - 1] = dbs[ns - 1][inv_sdf]
    dws[ns] = dws[ns][np.argsort(_rad_perm(st.vdim, F, st.idr))]
    c = ns + nr
    return dws[:ns], dbs[:ns], dws[ns:c], dbs[ns:c], dws[c:], dbs[c:]


def render_core_bwd(st: CoreStages, t: K4Stages, x: torch.Tensor,
                    dirs: torch.Tensor, cot: torch.Tensor,
                    detach_light: bool = True,
                    grad: torch.Tensor | None = None):
    """K4: the gradients of <cot, [grad | sdf | rgb | lmask]> with respect
    to the materialized weights and biases of the nets (unclamped
    outputs), from K3's pack `st` and `t` (`K4Stages` of the same
    weights), as (dws_sdf, dbs_sdf, dws_rad, dbs_rad, dws_l, dbs_l) lists
    of f32 tensors (the light lists empty without a light head; with one,
    `detach_light` off lets the light cotangent reach the SDF net through
    the features). In idr mode `grad` is the unclamped spatial gradient
    K3 gave the same points (N, 3), the radiance input's gradient
    columns. CUDA tensors only: the plain backward is autograd of
    `render_core_train_plain`."""
    global bwd_launches, light_bwd_launches, idr_bwd_launches
    global light_idr_bwd_launches
    if not x.is_cuda:
        raise ValueError("render_core_bwd: the kernel takes CUDA tensors; "
                         "the plain backward is autograd of "
                         "render_core_train_plain")
    _check_points(x, dirs, "render_core_bwd")
    mma_pack.check_input(cot, "cot", cols=8)
    if cot.shape[0] != x.shape[0] or st.sdf.weights.device != x.device:
        raise ValueError("render_core_bwd: cotangents, points and weights "
                         "disagree in length or device")
    if st.idr:
        if grad is None:
            raise ValueError("render_core_bwd: the idr radiance net needs "
                             "K3's spatial gradient of the points")
        mma_pack.check_input(grad, "grad", cols=3)
        if grad.shape[0] != x.shape[0] or grad.device != x.device:
            raise ValueError("render_core_bwd: grad and points disagree in "
                             "length or device")
    n = x.shape[0]
    coupled = bool(st.n_light) and not detach_light
    plan = plan_for(st, t, n, coupled)
    if plan.dev is None or plan.dev[0].device != x.device:
        plan.dev = (torch.from_numpy(plan.reg).to(x.device),
                    torch.from_numpy(plan.script).to(x.device))
    reg, script = plan.dev
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=x.device)
    ws32 = torch.empty(plan.n32, dtype=torch.float32, device=x.device)
    out = torch.empty(plan.n_out, dtype=torch.float32, device=x.device)
    nl = st.n_light
    lib = build.load_library()
    with torch.profiler.record_function("render_core_bwd" + _variant(st)):
        err = lib.i2sdf_render_core_bwd(
            x.data_ptr(), dirs.data_ptr(), cot.data_ptr(), n, plan.blocks,
            st.sdf.weights.data_ptr(), st.sdf.biases.data_ptr(),
            st.sdf.plan.ctypes.data, st.sdf.n_layers,
            st.rad.weights.data_ptr(), st.rad.biases.data_ptr(),
            st.rad.plan.ctypes.data, st.rad.n_layers,
            *((st.light.weights.data_ptr(), st.light.biases.data_ptr(),
               st.light.plan.ctypes.data) if nl else (None, None, None)), nl,
            t.t.weights.data_ptr(), t.tsdf.ctypes.data, t.tsdf.shape[0],
            t.trad.ctypes.data, t.tlight.ctypes.data if nl else None,
            t.wsdf.data_ptr(), int(bool(detach_light)), st.mx, st.md, st.F,
            *((grad.data_ptr(), t.wgr.data_ptr()) if st.idr else (None, None)),
            scratch.data_ptr(), ws32.data_ptr(), reg.data_ptr(),
            script.data_ptr(), plan.script.shape[0], plan.jobs.ctypes.data,
            plan.jobs.shape[0], plan.db_host.ctypes.data, out.data_ptr(),
            mma_pack.stream_of(x))
    build.check(err, "render_core_bwd")
    if nl and st.idr:
        light_idr_bwd_launches += 1
    elif nl:
        light_bwd_launches += 1
    elif st.idr:
        idr_bwd_launches += 1
    else:
        bwd_launches += 1
    return unpack_grads(st, t, out, plan)


class RenderCoreTrain(torch.autograd.Function):
    """The training op on the card: K3 forward, K4 backward.

    apply(icfg, rcfg, lcfg, detach_light, x, dirs, *weights.flat()) ->
    (sdf, grad, rgb), and the light mask with a light head (`lcfg`),
    unclamped. Gradients flow to the weights and biases only (x and dirs
    are constants: sampler depths and cameras). The forward's pack
    (`CoreStages`) stays in `ctx` for the backward, which packs only the
    transposed chains (`K4Stages`); in idr mode so does K3's unclamped
    gradient, the radiance input K4 takes."""

    @staticmethod
    def forward(ctx, icfg, rcfg, lcfg, detach_light, x, dirs, *flat):
        w = CoreWeights.unflat(flat, n_layers(icfg), n_layers(rcfg),
                               n_layers(lcfg))
        ctx.stages = CoreStages(icfg, rcfg, w, lcfg)
        outs = _launch_fwd(ctx.stages, x, dirs)
        ctx.save_for_backward(x, dirs, *flat)
        ctx.grad = outs[1].detach() if ctx.stages.idr else None
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
        grads = render_core_bwd(ctx.stages, K4Stages(icfg, rcfg, w, lcfg),
                                x, dirs, cot, detach_light, ctx.grad)
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
