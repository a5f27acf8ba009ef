"""Material-stage dataset (counterpart of `i2sdf_tpu/data/material.py`):
a scan's images (HDR through the port's EXR reader with `is_hdr`),
cameras and optional object masks (ones where the scan has none), with
`downsample_train` area-downscaling the images and masks to (H // f,
W // f) as OpenCV's INTER_AREA does (`utils/imaging.resize_area`) and
dividing the intrinsics' first two rows by f. numpy arrays, as the JAX
loader gives them.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import imaging
from ..utils.cameras import load_K_Rt_from_P


class MaterialData:
    def __init__(self, data_dir: str, scan_id: int = 0,
                 data_root: str = "data", use_mask: bool = False,
                 is_hdr: bool = False, downsample_train: int = 1,
                 **_unused):
        self.instance_dir = os.path.join(data_root, data_dir,
                                         f"scan{scan_id}")
        if not os.path.isdir(self.instance_dir):
            raise FileNotFoundError(f"no scan directory {self.instance_dir}")
        self.is_hdr = is_hdr
        image_paths = imaging.glob_imgs(os.path.join(
            self.instance_dir, "hdr" if is_hdr else "image"))
        self.n_images = len(image_paths)

        cams = np.load(os.path.join(self.instance_dir,
                                    "cameras_normalize.npz"))
        intr, pose = [], []
        for i in range(self.n_images):
            P = (cams[f"world_mat_{i}"].astype(np.float32)
                 @ cams[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
            K, c2w = load_K_Rt_from_P(P)
            intr.append(K)
            pose.append(c2w)
        self.intrinsics_all = np.stack(intr)
        self.pose_all = np.stack(pose)

        f = max(int(downsample_train), 1)

        def shrink(img):
            if f == 1:
                return img
            return imaging.resize_area(img, (img.shape[0] // f,
                                             img.shape[1] // f))

        rgbs = []
        for p in image_paths:
            img = shrink(imaging.load_rgb(p, is_hdr=is_hdr))
            self.img_res = [img.shape[0], img.shape[1]]
            rgbs.append(img.reshape(-1, 3))
        self.rgb_images = np.stack(rgbs)
        self.total_pixels = self.rgb_images.shape[1]
        if f > 1:
            self.intrinsics_all[:, :2, :] /= f

        self.use_mask = use_mask
        self.mask_images = None
        if use_mask:
            paths = imaging.glob_imgs(os.path.join(self.instance_dir,
                                                   "mask"))
            self.mask_images = (
                np.stack([shrink(imaging.load_mask(p)).reshape(-1, 1)
                          for p in paths]) if paths
                else np.ones((self.n_images, self.total_pixels, 1),
                             np.float32))

        H, W = self.img_res
        jj, ii = np.meshgrid(np.arange(W), np.arange(H))
        self.uv = np.stack([jj, ii], -1).reshape(-1, 2).astype(np.float32)

    def __len__(self) -> int:
        return self.n_images * self.total_pixels
