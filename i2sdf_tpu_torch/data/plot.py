"""Full-image evaluation data (counterpart of `i2sdf_tpu/data/plot.py`).

Cameras come from `cameras_normalize.npz` (`world_mat_i @ scale_mat_i`,
decomposed with numpy), images from `image/*.png`. Only the requested
views are read. `downsample` takes an area mean and rescales the
intrinsics. The `val/` held-out cameras and HDR images are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import imaging
from ..utils.cameras import load_K_Rt_from_P


class PlotData:
    def __init__(self, data_dir: str, scan_id: int = 0,
                 data_root: str = "data", downsample: int = 1,
                 indices=None, **_unused):
        instance_dir = os.path.join(data_root, data_dir, f"scan{scan_id}")
        paths = imaging.glob_imgs(os.path.join(instance_dir, "image"),
                                  (".png",))
        if not paths:
            raise FileNotFoundError(f"no images under {instance_dir}/image")
        cams = np.load(os.path.join(instance_dir, "cameras_normalize.npz"))
        idx = (list(range(len(paths))) if indices is None
               else [int(i) for i in indices])
        intr, pose, rgb = [], [], []
        for i in idx:
            P = (cams[f"world_mat_{i}"].astype(np.float32)
                 @ cams[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
            K, c2w = load_K_Rt_from_P(P)
            if downsample > 1:
                K = K.copy()
                K[:2, :] /= downsample
            intr.append(K)
            pose.append(c2w)
            img = imaging.downsample_area(imaging.load_rgb(paths[i]),
                                          downsample)
            rgb.append(img.reshape(-1, 3))
        self.indices = idx
        self.img_res = list(img.shape[:2])
        self.intrinsics_all = np.stack(intr)
        self.pose_all = np.stack(pose)
        self.rgb_images = np.stack(rgb)
        self.n_images = len(idx)
        self.total_pixels = self.img_res[0] * self.img_res[1]
        H, W = self.img_res
        jj, ii = np.meshgrid(np.arange(W), np.arange(H))
        self.uv = np.stack([jj, ii], -1).reshape(-1, 2).astype(np.float32)

    def image_inputs(self, i: int):
        """Row i: (uv (HW, 2), intrinsics, pose, rgb_gt (HW, 3))."""
        return (self.uv, self.intrinsics_all[i], self.pose_all[i],
                self.rgb_images[i])
