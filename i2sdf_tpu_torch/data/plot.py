"""Full-image evaluation data (counterpart of `i2sdf_tpu/data/plot.py`).

Two sources, as the JAX package has them: the training dataset's arrays
handed over in memory (`data=`: intrinsics, poses, images, resolution and
light masks, `plot.py:58-65` there), or the scan directory, where cameras
come from `cameras_normalize.npz` (`world_mat_i @ scale_mat_i`,
decomposed with numpy) and images from `image/*.png` (`hdr/` with
`is_hdr`, linear); only the requested views are read, and no light masks
(JAX `plot.py:91-96` builds its `ReconData` without them either). With
`is_val` and a `val/` directory the views are the held-out ones
(`plot.py:69-89`): `val/`'s images (HDR with `is_hdr`) and the cameras
`val_mat_i @ scale_mat_0`; without `val/` the training views. The
selected views (`indices`) are then downsampled by an area mean, light
masks with the images (`plot.py:98-112`), and the intrinsics rescaled.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import imaging
from ..utils.cameras import load_K_Rt_from_P


def _downsample(imgs: np.ndarray, res, factor: int) -> np.ndarray:
    """(n, H*W, C) -> (n, h*w, C) area means."""
    H, W = res
    return np.stack([imaging.downsample_area(im.reshape(H, W, -1), factor)
                     .reshape(-1, im.shape[-1]) for im in imgs])


class PlotData:
    def __init__(self, data_dir: str | None = None, scan_id: int = 0,
                 data_root: str = "data", downsample: int = 1,
                 indices=None, data: dict | None = None,
                 is_val: bool = False, is_hdr: bool = False, **_unused):
        if data is not None:
            intr = np.asarray(data["intrinsics"])
            pose = np.asarray(data["pose"])
            rgb = np.asarray(data["rgb"])
            res = list(data["img_res"])
            lmask = (np.asarray(data["light_mask"])
                     if data.get("light_mask") is not None else None)
            idx = (list(range(len(rgb))) if indices is None
                   else [int(i) for i in indices])
            intr, pose, rgb = intr[idx], pose[idx], rgb[idx]
            if lmask is not None:
                lmask = lmask[idx]
        else:
            instance_dir = os.path.join(data_root, data_dir,
                                        f"scan{scan_id}")
            read = (self._read_val
                    if is_val and os.path.isdir(os.path.join(instance_dir,
                                                             "val"))
                    else self._read)
            intr, pose, rgb, res, idx = read(instance_dir, indices, is_hdr)
            lmask = None
        if downsample > 1:
            intr = intr.copy()
            intr[:, :2, :] /= downsample
            rgb = _downsample(rgb, res, downsample)
            if lmask is not None:
                lmask = _downsample(lmask, res, downsample)
            res = [res[0] // downsample, res[1] // downsample]
        self.indices = idx
        self.img_res = res
        self.intrinsics_all = intr
        self.pose_all = pose
        self.rgb_images = rgb
        self.lightmask_images = lmask
        self.n_images = len(idx)
        self.total_pixels = res[0] * res[1]
        H, W = res
        jj, ii = np.meshgrid(np.arange(W), np.arange(H))
        self.uv = np.stack([jj, ii], -1).reshape(-1, 2).astype(np.float32)

    @staticmethod
    def _views(instance_dir, sub, indices, is_hdr, camera):
        """The views `indices` of `sub/`'s images, each camera P from
        `camera(cams, i)`."""
        exts = imaging.HDR_EXTENSIONS if is_hdr else (".png",)
        paths = imaging.glob_imgs(os.path.join(instance_dir, sub), exts)
        if not paths:
            raise FileNotFoundError(f"no images under {instance_dir}/{sub}")
        cams = np.load(os.path.join(instance_dir, "cameras_normalize.npz"))
        idx = (list(range(len(paths))) if indices is None
               else [int(i) for i in indices])
        intr, pose, rgb = [], [], []
        for i in idx:
            K, c2w = load_K_Rt_from_P(camera(cams, i)[:3, :4])
            intr.append(K)
            pose.append(c2w)
            img = imaging.load_rgb(paths[i], is_hdr)
            rgb.append(img.reshape(-1, 3))
        return (np.stack(intr), np.stack(pose), np.stack(rgb),
                list(img.shape[:2]), idx)

    @classmethod
    def _read(cls, instance_dir, indices, is_hdr):
        return cls._views(
            instance_dir, "hdr" if is_hdr else "image", indices, is_hdr,
            lambda cams, i: (cams[f"world_mat_{i}"].astype(np.float32)
                             @ cams[f"scale_mat_{i}"].astype(np.float32)))

    @classmethod
    def _read_val(cls, instance_dir, indices, is_hdr):
        return cls._views(
            instance_dir, "val", indices, is_hdr,
            lambda cams, i: (cams[f"val_mat_{i}"].astype(np.float32)
                             @ cams["scale_mat_0"].astype(np.float32)))

    def image_inputs(self, i: int):
        """Row i: (uv (HW, 2), intrinsics, pose, rgb_gt (HW, 3))."""
        return (self.uv, self.intrinsics_all[i], self.pose_all[i],
                self.rgb_images[i])
