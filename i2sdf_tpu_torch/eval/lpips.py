"""LPIPS in PyTorch (counterpart of `i2sdf_tpu/eval/lpips.py`): the
AlexNet-LPIPS geometry and formula (`lpips.py:38-110` there), five ReLU
stages, channel-unit-normalized squared feature differences, weighted per
channel, averaged over space and summed over the stages.

Weights, as the JAX package takes them:

1. `i2sdf_tpu_torch/eval/lpips_weights.npz`, the real AlexNet-LPIPS
   parameters in the JAX package's layout (`conv{i}` HWIO kernels,
   `bias{i}`, `lin{i}`), used only when the file exists. It is not in the
   repository and nothing fetches it (`scripts/convert_lpips_weights.py`
   writes it on a machine that can download the weights).
2. Otherwise a deterministic random-feature proxy, He-normal convolutions
   drawn from a seeded `torch.Generator` and uniform linear heads, named
   `lpips-rf-torch`: the JAX package's proxy (`lpips-rf`) draws its
   weights from a JAX PRNG, so the two proxies' scores are not the same
   number and never carry the same name.

`lpips_distance(params, a, b)` takes the parameters as a dict of tensors
(the JAX package's own, converted, give its distances), so the function
is held to the JAX one on the same parameters.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "lpips_weights.npz")
PROXY_NAME = "lpips-rf-torch"
PROXY_SEED = 1234

# AlexNet feature stages: (kernel, stride, pad, in_ch, out_ch, pool_first)
STAGES = (
    (11, 4, 2, 3, 64, False),
    (5, 1, 2, 64, 192, True),
    (3, 1, 1, 192, 384, True),
    (3, 1, 1, 384, 256, False),
    (3, 1, 1, 256, 256, False),
)
_SHIFT = torch.tensor([-0.030, -0.088, -0.188])
_SCALE = torch.tensor([0.458, 0.448, 0.450])


def random_params() -> dict:
    """The proxy's weights: He-normal HWIO kernels drawn from a
    `torch.Generator` seeded with `PROXY_SEED`, zero biases, uniform
    linear heads."""
    gen = torch.Generator().manual_seed(PROXY_SEED)
    params = {}
    for i, (k, _, _, cin, cout, _) in enumerate(STAGES):
        std = float(np.sqrt(2.0 / (k * k * cin)))
        params[f"conv{i}"] = torch.randn((k, k, cin, cout),
                                         generator=gen) * std
        params[f"bias{i}"] = torch.zeros(cout)
        params[f"lin{i}"] = torch.full((cout,), 1.0 / cout)
    return params


def load_params() -> tuple[dict, str]:
    """(params, name): the real weights if the file exists, else the
    proxy."""
    if os.path.exists(WEIGHTS_PATH):
        raw = np.load(WEIGHTS_PATH)
        return {k: torch.from_numpy(raw[k]) for k in raw.files}, "lpips"
    return random_params(), PROXY_NAME


def _features(params: dict, x: torch.Tensor) -> list:
    """x: (N, H, W, 3) in [-1, 1] -> the five post-ReLU maps (N, C, h, w)."""
    h = ((x - _SHIFT.to(x)) / _SCALE.to(x)).permute(0, 3, 1, 2)
    feats = []
    for i, (_, stride, pad, _, _, pool_first) in enumerate(STAGES):
        if pool_first:
            h = F.max_pool2d(h, 3, 2)
        w = params[f"conv{i}"].to(x).permute(3, 2, 0, 1)
        h = torch.relu(F.conv2d(h, w, params[f"bias{i}"].to(x), stride,
                                pad))
        feats.append(h)
    return feats


def _unit_normalize(f, eps=1e-10):
    return f / torch.sqrt((f * f).sum(1, keepdim=True) + eps)


def lpips_distance(params: dict, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """a, b: (N, H, W, 3) in [-1, 1] -> (N,) LPIPS distances."""
    total = 0.0
    for i, (xa, xb) in enumerate(zip(_features(params, a),
                                     _features(params, b))):
        d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
        lin = params[f"lin{i}"].to(a)[None, :, None, None]
        total = total + (d * lin).sum(1).mean((1, 2))
    return total


def make_lpips(device="cpu"):
    """fn(pred, gt) -> float on (H, W, 3) images in [0, 1] (numpy or
    tensors), with `fn.name` the weights' name (`lpips` or
    `lpips-rf-torch`). Inputs below 32 pixels a side are resized
    bilinearly to 32, as the JAX package's `make_lpips` does, so that the
    AlexNet stack keeps non-empty maps."""
    params, name = load_params()
    params = {k: v.to(device) for k, v in params.items()}
    if name == PROXY_NAME:
        print(f"[WARN] LPIPS: no AlexNet weights at {WEIGHTS_PATH}; using "
              f"the deterministic random-feature proxy '{PROXY_NAME}' "
              "(stable across runs, not comparable to published LPIPS)")

    def compute(pred, gt) -> float:
        a, b = (torch.as_tensor(np.asarray(t, np.float32) if not
                                isinstance(t, torch.Tensor) else t,
                                dtype=torch.float32, device=device)[None]
                * 2.0 - 1.0 for t in (pred, gt))
        h, w = a.shape[1:3]
        if min(h, w) < 32:
            s = 32 / min(h, w)
            hw = (max(int(round(h * s)), 32), max(int(round(w * s)), 32))
            a, b = (F.interpolate(t.permute(0, 3, 1, 2), size=hw,
                                  mode="bilinear", align_corners=False,
                                  antialias=False).permute(0, 2, 3, 1)
                    for t in (a, b))
        with torch.no_grad():
            return float(lpips_distance(params, a, b)[0])

    compute.name = name
    return compute
