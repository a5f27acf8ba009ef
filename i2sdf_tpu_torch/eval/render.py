"""Novel-view evaluation (counterpart of `i2sdf_tpu/eval/render.py`):
render the selected views, write the artifacts, report PSNR, SSIM and
LPIPS per view and their means.

Artifacts under `<exp_dir>/eval/` (`eval/test/` with `is_val`, the
held-out `val/` views): `rendering/{i}_pred.png` and the pred|gt panel
`rendering/{i}.png`, `depth/{i}.npy` with a gray PNG, `normal/{i}w.npy`
(world), `normal/{i}.npy` and `.png` (camera), `metrics.txt` (with a
`# LPIPS implementation:` line naming the weights) and `metrics.npz`
(each metric's per-view values, `render.py:45-98` there). LPIPS is
`eval/lpips.py`'s: the real AlexNet weights if the repository holds
them, else the proxy `lpips-rf-torch`, which names its column. As in the
JAX package, the metrics compare the images as loaded (linear ones for
an HDR scene). In the light-mask config the render computes the light
mask too (K3 with the light head on the card) and, as the JAX package's
`eval/render.py`, writes none of it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.plot import PlotData
from ..train.step import make_eval_render_fn
from ..utils import imaging
from .lpips import make_lpips


def run_render_eval(model, conf, exp_dir: str, data_root: str = "data",
                    indices=None, full_res: bool = False,
                    is_val: bool = False, fused: bool = True) -> dict:
    """Returns the metrics' means and, per view, the seconds spent
    rendering it (host clock, synchronized) under "seconds". `fused=False`
    renders through the plain versions (`--no_fused`)."""
    device = next(model.parameters()).device
    ds_conf = dict(conf.dataset)
    downsample = 1 if full_res else ds_conf.get("downsample", 1)
    pd = PlotData(ds_conf["data_dir"], scan_id=ds_conf.get("scan_id", 0),
                  data_root=data_root, downsample=downsample,
                  indices=indices, is_val=is_val,
                  is_hdr=ds_conf.get("is_hdr", False))
    out_dir = os.path.join(exp_dir, "eval", "test" if is_val else "")
    for sub in ("rendering", "depth", "normal"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    render_image = make_eval_render_fn(
        model, chunk_size=conf.train.get("split_n_pixels", 12000),
        fused=fused)
    lp = make_lpips(device)

    H, W = pd.img_res
    rows, seconds = [], []
    for row, idx in enumerate(pd.indices):
        uv, K, pose, rgb_gt = pd.image_inputs(row)
        t0 = time.perf_counter()
        out = render_image(torch.from_numpy(uv).to(device),
                           torch.from_numpy(K).to(device),
                           torch.from_numpy(pose).to(device))
        out = {k: v.cpu().numpy() for k, v in out.items()}  # synchronizes
        seconds.append(time.perf_counter() - t0)
        pred = out["rgb_values"].reshape(H, W, 3)
        gt = rgb_gt.reshape(H, W, 3)
        depth = out["depth_values"].reshape(H, W)
        n_world = out["normal_map"].reshape(H, W, 3)
        n_cam = n_world @ pose[:3, :3]

        tag = f"{idx:04d}"
        np.save(f"{out_dir}/normal/{tag}w.npy", n_world)
        np.save(f"{out_dir}/normal/{tag}.npy", n_cam)
        imaging.write_png(f"{out_dir}/normal/{tag}.png",
                          imaging.to_u8((n_cam + 1.0) / 2.0))
        imaging.write_png(f"{out_dir}/rendering/{tag}_pred.png",
                          imaging.to_u8(pred))
        imaging.write_png(f"{out_dir}/rendering/{tag}.png",
                          np.concatenate([imaging.to_u8(pred),
                                          imaging.to_u8(gt)], axis=1))
        np.save(f"{out_dir}/depth/{tag}.npy", depth)
        imaging.write_png(f"{out_dir}/depth/{tag}.png", imaging.to_u8(
            depth / max(float(depth.max()), 1e-6)))
        m = {"psnr": imaging.psnr(pred, gt), "ssim": imaging.ssim(pred, gt),
             lp.name: lp(pred, gt)}
        rows.append(m)
        print(f"[{tag}] " + " ".join(f"{k}={v:.4g}" for k, v in m.items())
              + f" ({seconds[-1]:.3f} s)")

    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
        f.write(f"# IMAGE RESOLUTION {pd.img_res}\n")
        f.write(f"# LPIPS implementation: {lp.name} (lpips-rf-torch = "
                "deterministic random-feature proxy, not comparable to "
                "published LPIPS)\n")
        for idx, r in zip(pd.indices, rows):
            f.write(f"[{idx:04d}] " + " ".join(
                f"[{k.upper()}]{v:.4g}" for k, v in r.items()) + "\n")
        f.write("[MEAN] " + " ".join(
            f"[{k.upper()}]{v:.4g}" for k, v in means.items()) + "\n")
    np.savez_compressed(os.path.join(out_dir, "metrics.npz"),
                        **{k: np.array([r[k] for r in rows])
                           for k in rows[0]})
    print("[MEAN] " + " ".join(f"{k}={v:.4g}" for k, v in means.items()))
    return {**means, "seconds": seconds}
