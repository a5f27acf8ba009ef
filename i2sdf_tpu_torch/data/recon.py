"""Reconstruction dataset (counterpart of `i2sdf_tpu/data/recon.py`).

The scan directory layout is the reference's: `image/`, optional `mask/`,
`light_mask/`, `depth/`, `normal/`, and `cameras_normalize.npz` with
`world_mat_i`/`scale_mat_i` pairs. Depth is divided by `scale_mat[2,2]`
and valid in (1e-3, 6); normals are rotated from view to world; the
bubble point cloud is the valid depth unprojected, with `pointlinks`
(flat pixel -> point, -1 where invalid) and `pixlinks` (point -> flat
pixel). A modality whose directory is missing is switched off, as the JAX
loader does. Images are PNG (`utils/imaging.py`); depth and normal maps
EXR or `.npy`. Masks and light masks are not read yet: their losses are
off in the configs this port runs.

Every flat tensor is moved to the device once (`DeviceArrays`), and each
step gathers its ray batch there (`sample_batch`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..utils import imaging
from ..utils.cameras import load_K_Rt_from_P


@dataclasses.dataclass
class DeviceArrays:
    """Device-resident training tensors (None = modality absent)."""
    uv: torch.Tensor                   # (HW, 2)
    intrinsics: torch.Tensor           # (n, 4, 4)
    pose: torch.Tensor                 # (n, 4, 4)
    rgb: torch.Tensor                  # (n, HW, 3)
    depth: torch.Tensor | None = None         # (n, HW)
    depth_mask: torch.Tensor | None = None    # (n, HW) bool
    normal: torch.Tensor | None = None        # (n, HW, 3)
    normal_mask: torch.Tensor | None = None   # (n, HW) bool
    pointcloud: torch.Tensor | None = None    # (P, 3)
    pointlinks: torch.Tensor | None = None    # (n*HW,) int64, -1 invalid
    pixlinks: torch.Tensor | None = None      # (P,) int64 flat pixel


def depth_to_world(uv, K, pose, depth, mask) -> np.ndarray:
    """Unproject the valid depth pixels to world points (P, 3)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy, sk = K[0, 2], K[1, 2], K[0, 1]
    x, y = uv[:, 0], uv[:, 1]
    z = np.ones_like(x)
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    xyz = np.stack([x_lift, y_lift, z], axis=-1) * depth[:, None]
    xyz = xyz[mask]
    xyz_h = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=-1)
    world = xyz_h @ pose.T
    return world[:, :3] / world[:, 3:]


class ReconData:
    def __init__(self, data_dir: str, scan_id: int = 0,
                 data_root: str = "data", use_mask: bool = False,
                 use_depth: bool = False, use_normal: bool = False,
                 use_bubble: bool = False, use_lightmask: bool = False,
                 is_hdr: bool = False, noise_scale: float = 0.0,
                 pdf_prune: float = 0.0, pdf_max: float | None = None,
                 **_unused):
        self.instance_dir = os.path.join(data_root, data_dir,
                                         f"scan{scan_id}")
        if not os.path.isdir(self.instance_dir):
            raise FileNotFoundError(f"no scan directory {self.instance_dir}")
        if is_hdr or use_mask or noise_scale > 0:
            raise ValueError("HDR images, masks and depth noise are not "
                             "ported yet")
        if use_lightmask and os.path.isdir(
                os.path.join(self.instance_dir, "light_mask")):
            raise ValueError("the light-mask loss is not ported yet")
        image_paths = imaging.glob_imgs(
            os.path.join(self.instance_dir, "image"), (".png",))
        self.n_images = len(image_paths)
        if not self.n_images:
            raise FileNotFoundError(f"no images under {self.instance_dir}"
                                    "/image")
        cams = np.load(os.path.join(self.instance_dir,
                                    "cameras_normalize.npz"))
        self.scale_mats = [cams[f"scale_mat_{i}"].astype(np.float32)
                           for i in range(self.n_images)]
        intr, pose = [], []
        for i, scale_mat in enumerate(self.scale_mats):
            P = (cams[f"world_mat_{i}"].astype(np.float32)
                 @ scale_mat)[:3, :4]
            K, c2w = load_K_Rt_from_P(P)
            intr.append(K)
            pose.append(c2w)
        self.intrinsics_all = np.stack(intr)
        self.pose_all = np.stack(pose)
        rgb = [imaging.load_rgb(p) for p in image_paths]
        self.img_res = list(rgb[0].shape[:2])
        self.rgb_images = np.stack([r.reshape(-1, 3) for r in rgb])
        self.total_pixels = self.rgb_images.shape[1]
        H, W = self.img_res
        jj, ii = np.meshgrid(np.arange(W), np.arange(H))
        self.uv = np.stack([jj, ii], -1).reshape(-1, 2).astype(np.float32)

        self.pdf_prune, self.pdf_max = pdf_prune, pdf_max
        depth_dir = os.path.join(self.instance_dir, "depth")
        self.use_depth = use_depth and os.path.isdir(depth_dir)
        self.use_bubble = use_bubble and os.path.isdir(depth_dir)
        self.depth_images = self.depth_masks = None
        self.pointcloud = self.pointlinks = self.pixlinks = None
        if self.use_depth or self.use_bubble:
            depths = [imaging.load_depth(p).reshape(-1)
                      / self.scale_mats[i][2, 2]
                      for i, p in enumerate(imaging.glob_imgs(depth_dir))]
            self.set_depth(np.stack(depths).astype(np.float32))

        normal_dir = os.path.join(self.instance_dir, "normal")
        self.use_normal = use_normal and os.path.isdir(normal_dir)
        self.normal_images = self.normal_masks = None
        if self.use_normal:
            self.set_normals(np.stack([
                imaging.load_normal(p).reshape(-1, 3)
                for p in imaging.glob_imgs(normal_dir)]))

    def set_depth(self, depth: np.ndarray) -> None:
        """Depth (n, HW) in scene units: the validity window, and with the
        bubble loss on, the point cloud and its links."""
        masks = (depth > 1e-3) & (depth < 6.0)
        self.depth_images = depth.astype(np.float32)
        self.depth_masks = masks
        if not self.use_bubble:
            return
        clouds, links, pix = [], [], []
        n_points = 0
        for i in range(self.n_images):
            m = masks[i]
            n_valid = int(m.sum())
            pl = -np.ones(self.total_pixels, np.int64)
            pl[m] = np.arange(n_valid) + n_points
            links.append(pl)
            pix.append(np.arange(i * self.total_pixels,
                                 (i + 1) * self.total_pixels)[m])
            clouds.append(depth_to_world(self.uv, self.intrinsics_all[i],
                                         self.pose_all[i], depth[i], m))
            n_points += n_valid
        self.pointcloud = np.concatenate(clouds).astype(np.float32)
        self.pointlinks = np.concatenate(links)
        self.pixlinks = np.concatenate(pix)

    def set_normals(self, normals: np.ndarray) -> None:
        """View-space normals (n, HW, 3) -> unit world normals and their
        validity (finite, not near zero)."""
        out, masks = [], []
        for i in range(self.n_images):
            nv = normals[i].astype(np.float32)
            finite = np.isfinite(nv).all(axis=1)
            nv = np.nan_to_num(nv)
            valid = (np.linalg.norm(nv, axis=1) > 1e-3) & finite
            nw = nv @ self.pose_all[i][:3, :3].T
            norm = np.maximum(np.linalg.norm(nw, axis=1, keepdims=True), 1e-6)
            out.append((nw / norm).astype(np.float32))
            masks.append(valid)
        self.normal_images = np.stack(out)
        self.normal_masks = np.stack(masks)

    def __len__(self) -> int:
        return self.n_images * self.total_pixels

    def to_device(self, device) -> DeviceArrays:
        def put(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(device)

        return DeviceArrays(
            uv=put(self.uv), intrinsics=put(self.intrinsics_all),
            pose=put(self.pose_all), rgb=put(self.rgb_images),
            depth=put(self.depth_images), depth_mask=put(self.depth_masks),
            normal=put(self.normal_images),
            normal_mask=put(self.normal_masks),
            pointcloud=put(self.pointcloud), pointlinks=put(self.pointlinks),
            pixlinks=put(self.pixlinks))


def sample_batch(data: DeviceArrays, idx: torch.Tensor):
    """The ray batch at flat indices `idx` (B,) into (image, pixel).

    Returns (inputs, ground_truth) with inputs shaped for `render_rays` as
    B batches of one pixel, as the reference collates rays."""
    hw = data.rgb.shape[1]
    img, pidx = idx // hw, idx % hw
    inputs = {"uv": data.uv[pidx][:, None, :],
              "intrinsics": data.intrinsics[img],
              "pose": data.pose[img]}
    gt = {"rgb": data.rgb[img, pidx]}
    if data.depth is not None:
        gt["depth"] = data.depth[img, pidx]
        gt["depth_mask"] = data.depth_mask[img, pidx]
    if data.normal is not None:
        gt["normal"] = data.normal[img, pidx]
        gt["normal_mask"] = data.normal_mask[img, pidx]
    return inputs, gt
