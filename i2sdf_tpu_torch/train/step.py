"""Chunked full-image eval render (counterpart of
`i2sdf_tpu/train/step.py::make_eval_render_fn`)."""

from __future__ import annotations

import torch

from ..models import renderer


def make_eval_render_fn(model: renderer.I2SDFModel, chunk_size: int):
    """Returns render_image(uv (HW, 2), intrinsics (4, 4), pose (4, 4)) ->
    dict of (HW, ...) tensors. The image is cut into `chunk_size`-ray
    chunks (the last one zero-padded, as the reference pads it), each
    rendered by `render_rays`; the kernels' weights are packed once."""
    weights = renderer.KernelWeights.pack(model)

    def render_image(uv: torch.Tensor, intrinsics: torch.Tensor,
                     pose: torch.Tensor) -> dict:
        n = uv.shape[0]
        n_pad = (-n) % chunk_size
        uv_p = torch.cat([uv, uv.new_zeros((n_pad, 2))]) if n_pad else uv
        outs = []
        for chunk in uv_p.split(chunk_size):
            outs.append(renderer.render_rays(
                model, {"uv": chunk[None], "intrinsics": intrinsics[None],
                        "pose": pose[None]}, weights=weights))
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}

    return render_image
