"""Mesh extraction and scoring (counterpart of `i2sdf_tpu/eval/mesh.py`).

* a coarse 100^3 SDF grid -> marching tetrahedra -> 10k surface samples
  -> PCA frame (det-sign fixed) -> an axis-aligned fine grid at
  `resolution` in that frame, rotated back to world -> its SDF ->
  marching -> un-rotate + scale_mat -> binary PLY;
* `--score`: re-fuse the predicted and the GT mesh through per-pose depth
  renders into a TSDF (the port's copy of the C++ rasterizer and TSDF,
  `native/`), then Chamfer Acc/Comp/Prec/Recall/F-score at 5 cm with a
  2 cm voxel downsample (its C++ KD-tree).

The SDF grids go through K1 (`ops/kernels/sdf_mlp.py::sdf_mlp_nograd`),
one pack an extraction, in 2 M-point chunks (the JAX package's `batch`):
a CUDA net launches the kernel, a CPU net takes its plain version. Each
chunk's points are built on the net's device from the three host axes
(flat index -> (i, j, k), then `@ vecs + mean` in f32), so the grid's
points never exist on the host (the JAX package builds them there: 1.6
GB at 512^3); the grid's values stay on the device and cross to the host
once, for the marching. The host geometry is numpy, as in the JAX
package: the PCA `eigh` (torch's could pick other eigenvector signs),
the det-sign row swap and `_aligned_grid`'s `np.arange` axes, which set
the fine grid's shape.

With a trained material stage (`--use_material`) the learned albedo is
baked onto the vertices as the PLY's colours.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from .. import native
from ..ops.kernels import sdf_mlp
from ..utils import imaging
from ..utils.cameras import load_K_Rt_from_P
from . import mesh_io

CHUNK = 2_000_000  # grid points a K1 launch


def _uniform_grid(resolution: int, boundary):
    """The coarse grid's three (equal) axes."""
    lo, hi = boundary
    xs = np.linspace(lo, hi, resolution, dtype=np.float32)
    return xs, xs, xs


def _aligned_grid(points: np.ndarray, resolution: int, eps: float = 0.1):
    """Axis ranges with equal spacing, densest along the shortest axis
    (parity plots.py get_grid:453-489); the JAX package's ranges."""
    mn = points.min(0) - eps
    mx = points.max(0) + eps
    extents = mx - mn
    shortest = int(np.argmin(extents))
    axis = np.linspace(mn[shortest], mx[shortest], resolution,
                       dtype=np.float32)
    step = (axis[-1] - axis[0]) / (resolution - 1)
    ranges = []
    for d in range(3):
        if d == shortest:
            ranges.append(axis)
        else:
            ranges.append(np.arange(mn[d], mx[d] + step, step,
                                    dtype=np.float32))
    return tuple(ranges)


def grid_points(axes, start: int, stop: int, frame=None) -> torch.Tensor:
    """Points start..stop-1 of the grid over `axes` (three 1-D tensors on
    one device), in the row-major (i, j, k) order of a meshgrid with
    "ij" indexing: (stop - start, 3) f32 on the axes' device. With
    `frame` = (vecs (3, 3), mean (3,)) tensors, the points are
    `p @ vecs + mean`, each product and sum in f32 (no TF32)."""
    ax, ay, az = axes
    idx = torch.arange(start, stop, device=ax.device)
    nyz = len(ay) * len(az)
    i = torch.div(idx, nyz, rounding_mode="floor")
    j = torch.div(idx % nyz, len(az), rounding_mode="floor")
    k = idx % len(az)
    p = torch.stack([ax[i], ay[j], az[k]], -1)
    if frame is None:
        return p
    vecs, mean = frame
    return (p[:, :1] * vecs[0] + p[:, 1:2] * vecs[1] + p[:, 2:] * vecs[2]
            + mean)


@torch.no_grad()
def _eval_sdf_grid(pack: sdf_mlp.SdfMlpPack, axes, frame=None,
                   batch: int = CHUNK, fused: bool = True) -> torch.Tensor:
    """The SDF over the grid of the host `axes` (optionally in `frame`,
    host (vecs, mean)), chunk by chunk through K1 (its plain version with
    `fused=False`, `--no_fused`): (nx, ny, nz) f32 on the net's device."""
    device = next(pack.net.parameters()).device
    dev = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(device)
    axes = [dev(a) for a in axes]
    if frame is not None:
        frame = tuple(dev(a) for a in frame)
    shape = tuple(len(a) for a in axes)
    n = shape[0] * shape[1] * shape[2]
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        pts = grid_points(axes, start, stop, frame)
        out[start:stop] = (sdf_mlp.sdf_mlp_nograd(pack, pts) if fused
                           else sdf_mlp.sdf_mlp_plain(pack.net, pts))
    return out.view(shape)


def _surface_frame(surf: np.ndarray):
    """(vecs (3, 3), mean (3,)) of surface samples: rows of vecs the
    principal axes, major first, with det > 0 (recon.py:68-69)."""
    mean = surf.mean(0)
    cov = (surf - mean).T @ (surf - mean)
    _, eigvecs = np.linalg.eigh(cov)
    vecs = eigvecs.T[::-1].copy()  # rows = principal axes, major first
    if np.linalg.det(vecs) < 0:
        vecs[[1, 2]] = vecs[[2, 1]]  # parity recon.py:68-69 row swap
    return vecs, mean


def _march(grid: np.ndarray, axes):
    return native.marching_cubes(
        grid, 0.0, origin=tuple(a[0] for a in axes),
        spacing=tuple(a[1] - a[0] for a in axes))


def _grid_on_host(pack, axes, frame, rec: dict, key: str,
                  fused: bool = True) -> np.ndarray:
    """The grid's SDF through K1, copied to the host once; its seconds
    (`{key}_grid_s`, the device's synchronized) and the copy's
    (`{key}_copy_s`) and what it made (`rec[key]`) go into rec."""
    clock = time.perf_counter
    t0 = clock()
    evaluate = (_eval_sdf_grid if fused
                else functools.partial(_eval_sdf_grid, fused=False))
    grid = evaluate(pack, axes, frame)
    if grid.is_cuda:
        torch.cuda.synchronize(grid.device)
    t1 = clock()
    host = grid.cpu().numpy()
    rec[f"{key}_grid_s"], rec[f"{key}_copy_s"] = t1 - t0, clock() - t1
    rec[key] = dict(axes=axes, frame=frame, grid=host)
    rec["points"] += host.size
    rec["chunks"] += -(-host.size // CHUNK)
    return host


def extract_mesh(net, resolution: int = 512, grid_boundary=(-1.5, 1.5),
                 scale_mat: np.ndarray | None = None,
                 coarse_resolution: int = 100, record: dict | None = None,
                 fused: bool = True):
    """Full two-stage extraction of the port's `ImplicitNet`; returns
    (verts, tris) in world scale or None when no surface crosses zero.

    With `record` (a dict), each stage's seconds (host clock) and what it
    made are written into it: `coarse` and `fine` (axes, frame, the host
    grid), `coarse_mesh`, `surface`, `frame` (vecs, mean), `points` and
    `chunks` (K1's launches on a CUDA net). `fused=False` takes K1's plain
    version (`--no_fused`)."""
    clock = time.perf_counter
    pack = sdf_mlp.SdfMlpPack(net)
    rec = {} if record is None else record
    rec.update(points=0, chunks=0)

    # stage 1: coarse grid -> PCA frame of the surface
    axes = _uniform_grid(coarse_resolution, grid_boundary)
    grid = _grid_on_host(pack, axes, None, rec, "coarse", fused)
    if grid.min() > 0 or grid.max() < 0:
        return None
    t0 = clock()
    verts_c, tris_c = _march(grid, axes)
    t1 = clock()
    surf = mesh_io.sample_surface(verts_c, tris_c, 10_000)
    t2 = clock()
    vecs, mean = _surface_frame(surf)
    aligned = (surf - mean) @ vecs.T
    axes = _aligned_grid(aligned, resolution)
    rec.update(coarse_march_s=t1 - t0, sample_s=t2 - t1,
               frame_s=clock() - t2, coarse_mesh=(verts_c, tris_c),
               surface=surf, frame=(vecs, mean))

    # stage 2: fine grid in the aligned frame, rotated back to world
    grid = _grid_on_host(pack, axes, (vecs, mean), rec, "fine", fused)
    if grid.min() > 0 or grid.max() < 0:
        return None
    t0 = clock()
    verts_a, tris = _march(grid, axes)
    rec["fine_march_s"] = clock() - t0
    verts = verts_a @ vecs + mean
    if scale_mat is not None:
        verts = mesh_io.transform_verts(verts, scale_mat)
    return verts.astype(np.float32), tris


def refuse(verts, tris, poses, K, H, W, far_clip: float = 5.0,
           voxel_length: float = 0.01):
    """Depth-render the mesh from every pose and TSDF-fuse it back
    (parity mesh_util.py:90-115). Returns (verts, tris)."""
    lo = verts.min(0) - 3 * voxel_length
    hi = verts.max(0) + 3 * voxel_length
    # keep the volume under 640^3 by coarsening the voxel, NOT by
    # clipping the region (clipping silently truncates the fused mesh)
    max_extent = float((hi - lo).max())
    if max_extent / voxel_length > 639:
        voxel_length = max_extent / 639.0
    dims = np.ceil((hi - lo) / voxel_length).astype(int) + 1
    vol = native.TSDFVolume(origin=lo, dims=dims, voxel_size=voxel_length,
                            sdf_trunc=3 * voxel_length, depth_max=far_clip)
    for pose in poses:
        w2c = np.linalg.inv(np.asarray(pose, np.float64)).astype(np.float32)
        depth = native.rasterize_depth(verts, tris, K, w2c, H, W)
        vol.integrate(depth, K, w2c)
    return vol.extract_mesh()


def depth2mesh(depths, poses, K, H, W, voxel_length: float = 0.01,
               far_clip: float = 5.0, origin=None, extent: float = 6.0):
    """TSDF-fuse raw depth maps into a mesh (parity mesh_util.py:117-135)."""
    if origin is None:
        origin = np.array([-extent / 2] * 3, np.float32)
    dims = np.minimum(int(np.ceil(extent / voxel_length)) + 1, 640)
    vol = native.TSDFVolume(origin=origin, dims=(dims,) * 3,
                            voxel_size=voxel_length,
                            sdf_trunc=3 * voxel_length, depth_max=far_clip)
    for depth, pose in zip(depths, poses):
        w2c = np.linalg.inv(np.asarray(pose, np.float64)).astype(np.float32)
        vol.integrate(np.asarray(depth, np.float32), K, w2c)
    return vol.extract_mesh()


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """One representative point per occupied voxel (open3d parity)."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def evaluate(verts_pred, verts_gt, threshold: float = 0.05,
             down_sample: float = 0.02) -> dict:
    """Chamfer Acc/Comp/Prec/Recall/F-score (parity mesh_util.py:25-52)."""
    p = np.asarray(verts_pred, np.float32)
    g = np.asarray(verts_gt, np.float32)
    if down_sample:
        p = voxel_downsample(p, down_sample)
        g = voxel_downsample(g, down_sample)
    dist_gt_to_pred = native.nn_distances(p, g)   # dist1 in the reference
    dist_pred_to_gt = native.nn_distances(g, p)   # dist2
    precision = float(np.mean(dist_pred_to_gt < threshold))
    recall = float(np.mean(dist_gt_to_pred < threshold))
    fscore = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
    return {
        "Acc": float(np.mean(dist_pred_to_gt)),
        "Comp": float(np.mean(dist_gt_to_pred)),
        "Prec": precision,
        "Recal": recall,
        "F-score": fscore,
    }


def _cameras(instance_dir: str, cams):
    """The scan's (poses, intrinsics) in world scale, one per image."""
    n_imgs = len(imaging.glob_imgs(os.path.join(instance_dir, "image")))
    Ks, poses = [], []
    for i in range(n_imgs):
        K_i, pose_i = load_K_Rt_from_P(cams[f"world_mat_{i}"][:3, :])
        Ks.append(K_i)
        poses.append(pose_i)
    return poses, Ks


def run_mesh_eval(model, conf, exp_dir: str, data_root: str = "data",
                  resolution: int = 512, score: bool = False,
                  far_clip: float = 5.0, fused: bool = True,
                  material=None) -> str | None:
    """Full `--test_mode mesh` flow incl. optional scoring; returns the
    PLY path (parity recon.py:92-129). Writes `eval/mesh/scan{N}.ply` and
    `.html` (the training cameras' frusta), and with `score` the refused
    meshes `scan{N}_refined.ply`, `scan{N}_gt.ply` and `metrics.txt`
    (no score, with a warning, when the scan has no `mesh.ply`).
    `material`, a trained stage from `train/material.py::
    load_material_stage`, bakes its albedo onto the vertices (the PLY's
    uchar colours), evaluated in chunks of 262,144 at the vertices taken
    back through `scale_mat` to the scene's normalized frame."""
    from ..train.artifacts import write_mesh_html

    scan_id = conf.dataset.get("scan_id", 0)
    instance_dir = os.path.join(data_root, conf.dataset.data_dir,
                                f"scan{scan_id}")
    cams = np.load(os.path.join(instance_dir, "cameras_normalize.npz"))
    scale_mat = cams["scale_mat_0"]

    record: dict = {}
    t0 = time.perf_counter()
    result = extract_mesh(
        model.implicit, resolution=resolution,
        grid_boundary=tuple(conf.plot.grid_boundary), scale_mat=scale_mat,
        record=record, fused=fused)
    seconds = time.perf_counter() - t0
    print("[INFO] mesh extraction: " + " ".join(
        f"{k}={record[k]:.3f}" for k in (
            "coarse_grid_s", "coarse_march_s", "sample_s", "frame_s",
            "fine_grid_s", "fine_copy_s", "fine_march_s") if k in record)
        + f" points={record['points']} chunks={record['chunks']} "
        f"total_s={seconds:.3f}")
    if result is None:
        print("[WARN] SDF has no zero crossing; no mesh extracted")
        return None
    verts, tris = result
    colors = None
    if material is not None:
        stage = material[0]
        dev = next(stage.parameters()).device
        inv = np.linalg.inv(np.asarray(scale_mat, np.float64))
        vn = (verts @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
        with torch.no_grad():
            colors = np.concatenate([
                stage.material(torch.from_numpy(vn[s:s + 262_144]).to(
                    dev))["kd"].cpu().numpy()
                for s in range(0, len(vn), 262_144)])
        print(f"[INFO] baked learned albedo onto {len(colors)} mesh "
              "vertices")
    mesh_dir = os.path.join(exp_dir, "eval", "mesh")
    os.makedirs(mesh_dir, exist_ok=True)
    ply_path = os.path.join(mesh_dir, f"scan{scan_id}.ply")
    mesh_io.write_ply(ply_path, verts, tris, colors=colors)
    print(f"[INFO] mesh saved to {ply_path} "
          f"({len(verts)} verts, {len(tris)} tris)")

    # inspect-in-browser artifact with training-camera frusta
    # (parity plots.py:15-73,188-225)
    poses, Ks = _cameras(instance_dir, cams)
    write_mesh_html(verts, tris,
                    os.path.join(mesh_dir, f"scan{scan_id}.html"),
                    poses=np.asarray(poses) if poses else None,
                    intrinsics=np.asarray(Ks) if Ks else None)

    if score:
        image_dir = os.path.join(instance_dir, "image")
        sample = imaging.load_rgb(imaging.glob_imgs(image_dir)[0])
        H, W = sample.shape[0], sample.shape[1]
        # the JAX package's quirk, kept so that the scores match: every
        # pose is rendered with the last image's intrinsics
        K = Ks[-1]

        t0 = time.perf_counter()
        pv, pt = refuse(verts, tris, poses, K, H, W, far_clip)
        print(f"[INFO] refuse (pred): {time.perf_counter() - t0:.3f} s")
        mesh_io.write_ply(os.path.join(
            mesh_dir, f"scan{scan_id}_refined.ply"), pv, pt)
        gt_path = os.path.join(instance_dir, "mesh.ply")
        if not os.path.exists(gt_path):
            print(f"[WARN] no GT mesh at {gt_path}; skipping score")
            return ply_path
        gv, gt_t = mesh_io.read_ply(gt_path)
        t0 = time.perf_counter()
        gv, gt_t = refuse(gv, gt_t, poses, K, H, W, far_clip)
        print(f"[INFO] refuse (gt): {time.perf_counter() - t0:.3f} s")
        mesh_io.write_ply(os.path.join(
            mesh_dir, f"scan{scan_id}_gt.ply"), gv, gt_t)
        metrics = evaluate(pv, gv)
        with open(os.path.join(mesh_dir, "metrics.txt"), "w") as f:
            for k, v in metrics.items():
                f.write(f"{k.upper()}: {v}\n")
        print(f"[INFO] mesh metrics: {metrics}")
    return ply_path
