"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | module | replaces (TPU kernel) |
| --- | --- | --- |
| `sdf_mlp_nograd` | `sdf_mlp.py`, `csrc/sdf_mlp.cu` | `ops/pallas/fused_mlp.py:157 fused_sdf_mlp` |
| `sampler_round` | `sampler_round.py`, `csrc/sampler_round.cu` | `ops/pallas/sampler_round.py:218 sampler_round_pallas` |
| `render_core_fwd` | `render_core.py`, `csrc/render_core.cu` | forward of `ops/pallas/fused_train.py:449 get_render_core_op` |
| `render_core_bwd` | `render_core.py`, `csrc/render_core_bwd.cu` | backward of `ops/pallas/fused_train.py:449 get_render_core_op` |
| `render_core_fwd_light` | `render_core.py`, `csrc/render_core.cu` | forward of the same op with the light head (`lcfg`) |
| `render_core_bwd_light` | `render_core.py`, `csrc/render_core_bwd.cu` | backward of the same op with the light head |
| `render_core_fwd_idr` | `render_core.py`, `csrc/render_core.cu` | forward of the same op with the idr-mode radiance net (`idr`) |
| `render_core_bwd_idr` | `render_core.py`, `csrc/render_core_bwd.cu` | backward of the same op with the idr-mode radiance net |
| `render_core_fwd_light_idr` | `render_core.py`, `csrc/render_core.cu` | forward of the same op with the light head beside the idr-mode radiance net (`lcfg`, `idr`) |
| `render_core_bwd_light_idr` | `render_core.py`, `csrc/render_core_bwd.cu` | backward of the same op with the light head beside the idr-mode radiance net |
| `rev_fwd` | `rev.py`, `csrc/rev_fwd.cu` | forward of `ops/pallas/fused_rev.py:213 get_rev_op` |
| `rev_bwd` | `rev.py`, `csrc/rev_bwd.cu` | backward of `ops/pallas/fused_rev.py:213 get_rev_op` |
| `conv_check` | `conv_check.py`, `csrc/conv_check.cu` | `ops/pallas/sampler_round.py:355 conv_check_pallas` |
| `bg_core_fwd` | `bg_core.py`, `csrc/bg_core.cu` | forward of `ops/pallas/fused_bg.py:209 get_bg_core_op` |
| `bg_core_bwd` | `bg_core.py`, `csrc/bg_core_bwd.cu` | backward of `ops/pallas/fused_bg.py:209 get_bg_core_op` |
| `sdf_outputs` | `sdf_outputs.py`, `csrc/sdf_outputs.cu` | `ops/pallas/fused_outputs.py:95 fused_sdf_outputs` |
| `sdf_grad_fwd` | `sdf_grad.py`, `csrc/sdf_grad_fwd.cu` | forward of `ops/pallas/fused_grad.py:250 get_sdf_outputs_op` |
| `sdf_grad_bwd` | `sdf_grad.py`, `csrc/sdf_grad_bwd.cu` | backward of `ops/pallas/fused_grad.py:250 get_sdf_outputs_op` |

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
the plain PyTorch version for CPU tensors. Each kernel has a plain
integer counter in its module that its wrapper increments once per
kernel launch (`launches` in `sdf_mlp.py`, `sampler_round.py`,
`conv_check.py` and `sdf_outputs.py`; `launches` and `bwd_launches` in
`render_core.py`, `rev.py`, `bg_core.py` and `sdf_grad.py`;
`light_launches`, `light_bwd_launches`, `idr_launches`,
`idr_bwd_launches`, `light_idr_launches` and `light_idr_bwd_launches` in
`render_core.py`).

With K10-K12 every `pl.pallas_call` site of the JAX package has its
counterpart here. K1, K3, K4, K5, K6, K8, K9 and K10 are built on the
wgmma layer primitive `csrc/wgmma_layer.cuh`; K3 and K10 share its
four-stream tangent form, `csrc/tangent_form.cuh`; K4, K5, K6 and K9 its
backward-sweep pieces, `csrc/wgmma_sweep.cuh`, and K4, K5 and K6 the SDF
net's sweeps, `csrc/sdf_sweep.cuh`. K11 is K10 at sphere radius 0 and
K12 is K6: their kernels on K6's pack, each through its own C entry and
counter.
"""

from . import (bg_core, conv_check, render_core, rev, sampler_round,
               sdf_grad, sdf_mlp, sdf_outputs)

KERNELS = {
    "sdf_mlp_nograd": (sdf_mlp, "launches"),
    "sampler_round": (sampler_round, "launches"),
    "render_core_fwd": (render_core, "launches"),
    "render_core_bwd": (render_core, "bwd_launches"),
    "render_core_fwd_light": (render_core, "light_launches"),
    "render_core_bwd_light": (render_core, "light_bwd_launches"),
    "render_core_fwd_idr": (render_core, "idr_launches"),
    "render_core_bwd_idr": (render_core, "idr_bwd_launches"),
    "render_core_fwd_light_idr": (render_core, "light_idr_launches"),
    "render_core_bwd_light_idr": (render_core, "light_idr_bwd_launches"),
    "rev_fwd": (rev, "launches"),
    "rev_bwd": (rev, "bwd_launches"),
    "conv_check": (conv_check, "launches"),
    "bg_core_fwd": (bg_core, "launches"),
    "bg_core_bwd": (bg_core, "bwd_launches"),
    "sdf_outputs": (sdf_outputs, "launches"),
    "sdf_grad_fwd": (sdf_grad, "launches"),
    "sdf_grad_bwd": (sdf_grad, "bwd_launches"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
