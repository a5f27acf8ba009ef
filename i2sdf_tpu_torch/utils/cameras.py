"""Camera geometry (counterpart of `i2sdf_tpu/utils/cameras.py`).

OpenCV convention (x right, y down, z forward), intrinsics with skew,
pose as camera-to-world 4x4. The projection-matrix decomposition is
host-side numpy (an RQ decomposition, no OpenCV); ray generation is torch.
"""

from __future__ import annotations

import numpy as np
import torch


def rq_decompose(M: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """RQ-decompose a 3x3 matrix: M = R_upper @ Q with Q a rotation and
    diag(R_upper) >= 0, via QR of the antitransposed matrix."""
    P = np.flipud(np.eye(3))
    q, r = np.linalg.qr((P @ M).T)
    R_upper = P @ r.T @ P
    Q = P @ q.T
    signs = np.sign(np.diag(R_upper))
    signs[signs == 0] = 1.0
    D = np.diag(signs)
    R_upper = R_upper @ D
    Q = D @ Q
    if np.linalg.det(Q) < 0:
        Q = -Q
        R_upper = -R_upper
    return R_upper, Q


def load_K_Rt_from_P(P: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """3x4 projection -> (intrinsics 4x4 with K/K[2,2], c2w pose 4x4)."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    K, R = rq_decompose(M)
    C = -np.linalg.inv(M) @ P[:, 3]
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)
    pose[:3, 3] = C.astype(np.float32)
    return intrinsics, pose


def lift(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
         intrinsics: torch.Tensor) -> torch.Tensor:
    """Pixel coords (+depth z) -> homogeneous camera-space points
    (..., N, 4)."""
    fx = intrinsics[..., 0, 0][..., None]
    fy = intrinsics[..., 1, 1][..., None]
    cx = intrinsics[..., 0, 2][..., None]
    cy = intrinsics[..., 1, 2][..., None]
    sk = intrinsics[..., 0, 1][..., None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def get_camera_params(uv: torch.Tensor, pose: torch.Tensor,
                      intrinsics: torch.Tensor):
    """uv (B, N, 2), pose (B, 4, 4) c2w, intrinsics (B, 4, 4) ->
    (ray_dirs (B, N, 3) unnormalized, cam_loc (B, 3))."""
    if pose.shape[-1] != 4:
        raise ValueError("pose must be (B, 4, 4) camera-to-world matrices")
    cam_loc = pose[..., :3, 3]
    x_cam, y_cam = uv[..., 0], uv[..., 1]
    pixel_points_cam = lift(x_cam, y_cam, torch.ones_like(x_cam), intrinsics)
    world = torch.einsum("bij,bnj->bni", pose, pixel_points_cam)[..., :3]
    return world - cam_loc[..., None, :], cam_loc


def get_sphere_intersections(cam_loc: torch.Tensor,
                             ray_directions: torch.Tensor, r: float = 1.0):
    """Near/far intersections of unit rays with a sphere of radius r:
    ((N, 2) distances clamped to >= 0, (N,) hit mask)."""
    ray_cam_dot = (ray_directions * cam_loc).sum(-1, keepdim=True)
    under_sqrt = ray_cam_dot ** 2 - ((cam_loc ** 2).sum(-1, keepdim=True)
                                     - r ** 2)
    mask = (under_sqrt > 0).squeeze(-1)
    sqrt_term = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    sign = torch.tensor([-1.0, 1.0], dtype=cam_loc.dtype,
                        device=cam_loc.device)
    return torch.clamp(sqrt_term * sign - ray_cam_dot, min=0.0), mask
