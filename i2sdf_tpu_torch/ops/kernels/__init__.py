"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | module | replaces (TPU kernel) |
| --- | --- | --- |
| `sdf_mlp_nograd` | `sdf_mlp.py`, `csrc/sdf_mlp.cu` | `ops/pallas/fused_mlp.py:157 fused_sdf_mlp` |
| `sampler_round` | `sampler_round.py`, `csrc/sampler_round.cu` | `ops/pallas/sampler_round.py:218 sampler_round_pallas` |
| `render_core_fwd` | `render_core.py`, `csrc/render_core.cu` | forward of `ops/pallas/fused_train.py:449 get_render_core_op` |
| `render_core_bwd` | `render_core.py`, `csrc/render_core_bwd.cu` | backward of `ops/pallas/fused_train.py:449 get_render_core_op` |
| `render_core_fwd_light` | `render_core.py`, `csrc/render_core.cu` | forward of the same op with the light head (`lcfg`) |
| `render_core_bwd_light` | `render_core.py`, `csrc/render_core_bwd.cu` | backward of the same op with the light head |
| `rev_fwd` | `rev.py`, `csrc/rev_fwd.cu` | forward of `ops/pallas/fused_rev.py:213 get_rev_op` |
| `rev_bwd` | `rev.py`, `csrc/rev_bwd.cu` | backward of `ops/pallas/fused_rev.py:213 get_rev_op` |

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
the plain PyTorch version for CPU tensors. Each kernel has a plain
integer counter in its module that its wrapper increments once per
kernel launch (`launches` in `sdf_mlp.py` and `sampler_round.py`;
`launches` and `bwd_launches` in `render_core.py` and `rev.py`;
`light_launches` and `light_bwd_launches` in `render_core.py`).
"""

from . import render_core, rev, sampler_round, sdf_mlp

KERNELS = {
    "sdf_mlp_nograd": (sdf_mlp, "launches"),
    "sampler_round": (sampler_round, "launches"),
    "render_core_fwd": (render_core, "launches"),
    "render_core_bwd": (render_core, "bwd_launches"),
    "render_core_fwd_light": (render_core, "light_launches"),
    "render_core_bwd_light": (render_core, "light_bwd_launches"),
    "rev_fwd": (rev, "launches"),
    "rev_bwd": (rev, "bwd_launches"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
