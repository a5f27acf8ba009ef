"""K10 `sdf_outputs`: the SDF net's sdf, features and spatial gradient at
points, forward only, bounding-sphere clamped.

Replaces `i2sdf_tpu/ops/pallas/fused_outputs.py:95 fused_sdf_outputs`
(pallas_call at `:135`): (sdf, feature, d sdf / d x) at every sample, the
normal map's inputs on an eval render. The CUDA kernel is
`csrc/sdf_outputs.cu`: K3's wgmma tangent form (`csrc/tangent_form.cuh`)
on the SDF net alone, the features kept in f32, the clamp and its
gradient select in its epilogue. Operations bound it; its header counts
them.

* `OutputStages(icfg, ws, bs)`: K10's pack, K3's SDF stage chain
  (`render_core.core_sdf_layers`: the hidden layers, then the output
  layer as the sdf alone and the features), gathered from the net's flat
  weights through a layout built once for its shapes
  (`mma_pack.chain_index`); a net with no encoding runs as frequency
  count 0.
* `sdf_outputs_plain(net, points)`: the same function in plain f32
  PyTorch (`sdf_grad.sdf_tangents`, chunked). The CPU path and the tests
  use it; on the card it only serves as the yardstick the kernel is held
  to.
* `sdf_outputs_fwd(k, icfg, points)`: the launch, CUDA tensors only.
* `fused_sdf_outputs(net, points)`: the entry point. Like the JAX op,
  which has no AD rules (`fused_outputs.py:17-18`), it gives no gradient:
  it runs under `torch.no_grad()`, and a call where autograd would track
  the points or the net's parameters raises.
"""

from __future__ import annotations

import torch

from ...models import mlp
from . import build, mma_pack, render_core, sdf_grad

launches = 0  # K10 launches since the last reset_launch_counts()

_PLAIN_CHUNK = 1 << 16
_MAX_PE = 10  # frequencies the kernel's encoding cache holds (kPeStride)


def _weights(net: mlp.ImplicitNet):
    lins = net.layers()
    return [l.weight() for l in lins], [l.b for l in lins]


class OutputStages:
    """K10's pack from materialized (in, out) weights and biases: `sdf`,
    K3's SDF stage chain (the same bits as `render_core.CoreStages.sdf`
    for the same net); `F` the feature width, `mx` the encoding's
    frequency count (0: no encoding)."""

    def __init__(self, icfg: mlp.ImplicitNetConfig, ws, bs):
        F = icfg.feature_vector_size
        if icfg.d_out != 1 or icfg.output_activation is not None:
            raise ValueError("sdf_outputs: needs d_out 1 and no output "
                             "activation")
        self.F, self.mx = F, icfg.multires if icfg.embed_type else 0
        if self.mx > _MAX_PE:
            raise ValueError(f"sdf_outputs: more than {_MAX_PE} encoding "
                             "frequencies")
        shapes = tuple(tuple(t.shape) for t in ws)

        def chains(ws, bs):
            return (render_core.core_sdf_layers(icfg, ws, bs,
                                                embed_none=True),)

        ix = mma_pack.chain_index(("sdf_outputs", icfg, shapes), chains,
                                  shapes, (256,))
        with torch.no_grad():
            w, b = mma_pack.flat_sources(ws, bs)
            (sdf,) = ix.on(ws[0].device)
            self.sdf = mma_pack.gather_chain(sdf, w, b)
        plan = self.sdf.plan
        if (int(plan[:, :2].max()) > render_core._K3_WIDTH
                or F > render_core._K3_WIDTH):
            raise ValueError(f"sdf_outputs: a layer wider than "
                             f"{render_core._K3_WIDTH}")
        if not 3 <= self.sdf.n_layers <= render_core._MAX_LAYERS:
            raise ValueError("sdf_outputs: the kernel takes 1 to "
                             f"{render_core._MAX_LAYERS - 2} hidden layers")


def sdf_outputs_plain(net: mlp.ImplicitNet, points: torch.Tensor):
    """(sdf (N, 1), feat (N, F), grad (N, 3)) of the clamped SDF in f32,
    by the tangent sweep (chunked to bound memory)."""
    cfg = net.cfg
    outs = []
    with torch.no_grad():
        ws, bs = _weights(net)
        for x in points.split(_PLAIN_CHUNK):
            out, grad = sdf_grad.sdf_tangents(cfg, ws, bs, x)
            sdf, grad = render_core._sphere_clamp(cfg, x, out[:, :1], grad)
            outs.append((sdf, out[:, 1:], grad))
    if not outs:
        F = cfg.feature_vector_size
        return (points.new_zeros((0, 1)), points.new_zeros((0, F)),
                points.new_zeros((0, 3)))
    return tuple(torch.cat(o) for o in zip(*outs))


def sdf_outputs_fwd(k: OutputStages, icfg: mlp.ImplicitNetConfig,
                    points: torch.Tensor):
    """K10: (sdf (N, 1), feat (N, F), grad (N, 3)), the sdf clamped to the
    bounding sphere of `icfg` and the gradient the sphere's where it
    wins."""
    global launches
    if not points.is_cuda:
        raise ValueError("sdf_outputs: the kernel takes CUDA tensors; the "
                         "plain version runs on the CPU")
    mma_pack.check_input(points, "x", cols=3)
    if k.sdf.weights.device != points.device:
        raise ValueError("sdf_outputs: the weights are not on the points' "
                         "device")
    n = points.shape[0]
    out = torch.empty((n, k.F + 1), dtype=torch.float32,
                      device=points.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=points.device)
    if n:
        err = build.load_library().i2sdf_sdf_outputs(
            points.data_ptr(), n, k.sdf.weights.data_ptr(),
            k.sdf.biases.data_ptr(), k.sdf.plan.ctypes.data, k.sdf.n_layers,
            k.mx, k.F, float(icfg.sdf_bounding_sphere),
            float(icfg.sphere_scale), out.data_ptr(), grad.data_ptr(),
            mma_pack.stream_of(points))
        build.check(err, "sdf_outputs")
        launches += 1
    return out[:, :1], out[:, 1:], grad


def fused_sdf_outputs(net: mlp.ImplicitNet, points: torch.Tensor):
    """(N, 3) -> (sdf (N, 1), feat (N, F), grad (N, 3)), forward only, the
    sdf clamped to the bounding sphere. CPU tensors take the plain
    version; CUDA tensors launch K10 (or raise)."""
    if torch.is_grad_enabled() and (
            points.requires_grad
            or any(p.requires_grad for p in net.parameters())):
        raise ValueError("fused_sdf_outputs: forward only, with no gradient; "
                         "call it under torch.no_grad()")
    if not points.is_cuda:
        return sdf_outputs_plain(net, points)
    with torch.no_grad():
        k = OutputStages(net.cfg, *_weights(net))
        return sdf_outputs_fwd(k, net.cfg, points)
