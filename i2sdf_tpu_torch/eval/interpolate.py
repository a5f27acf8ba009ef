"""View interpolation (counterpart of `i2sdf_tpu/eval/interpolate.py`):
slerp between two training poses, render the frames, assemble a video.

Capability parity with the reference's InterpolateDataset
(`dataset/eval_dataset.py:188-273`: quaternion slerp and sine-eased
translation) and ViewInterpolateSystem (`model/eval/recon.py:227-304`:
RGB and normal frames, an h264 video through ffmpeg when ffmpeg is on
the path, else the frame directories stay as they are). The frames
render through the port's eval render (`train/step.py::
make_eval_render_fn`: K1-K3 on the card). Only the two end views are
read (`PlotData(indices=[id0, id1])`). The JAX package renders with
`predict_only` when it writes no normal frames; its CLI always writes
them, and so does this module.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation, Slerp

from ..data.plot import PlotData
from ..train.step import make_eval_render_fn
from ..utils import imaging


def interpolate_poses(pose0: np.ndarray, pose1: np.ndarray,
                      num_frames: int) -> np.ndarray:
    """Slerp rotations, sine-ease translations (eval_dataset.py:219-241)."""
    rots = Rotation.from_matrix(
        np.stack([pose0[:3, :3], pose1[:3, :3]]))
    slerp = Slerp([0.0, 1.0], rots)
    t = np.arange(num_frames) / max(num_frames - 1, 1)
    ratio = np.sin((t - 0.5) * np.pi) * 0.5 + 0.5
    out = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    out[:, :3, :3] = slerp(t).as_matrix().astype(np.float32)
    out[:, :3, 3] = ((1 - ratio)[:, None] * pose0[:3, 3]
                     + ratio[:, None] * pose1[:3, 3])
    return out


def frames_to_video(frame_dir: str, out_path: str, frame_rate: int) -> bool:
    """Assemble PNG frames into an h264 mp4 when ffmpeg exists."""
    if shutil.which("ffmpeg") is None:
        print(f"[WARN] ffmpeg not available; frames remain in {frame_dir}")
        return False
    cmd = ["ffmpeg", "-y", "-framerate", str(frame_rate),
           "-pattern_type", "glob", "-i", os.path.join(frame_dir, "*.png"),
           "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
    subprocess.run(cmd, check=True, capture_output=True)
    return True


def run_interpolation(model, conf, exp_dir: str, id0: int, id1: int,
                      n_frames: int = 60, frame_rate: int = 24,
                      data_root: str = "data", fused: bool = True) -> str:
    """Render `n_frames` views from view id0's pose to id1's into
    `eval/interpolate/{id0:04d}_{id1:04d}/` (RGB) and `..._normal/`
    (camera-space normals), then the videos; returns the RGB frames'
    directory. `fused=False` renders through the plain versions
    (`--no_fused`)."""
    device = next(model.parameters()).device
    ds_conf = dict(conf.dataset)
    scan_id = ds_conf.get("scan_id", 0)
    pd = PlotData(ds_conf["data_dir"], scan_id=scan_id, data_root=data_root,
                  downsample=ds_conf.get("downsample", 1),
                  indices=[id0, id1])
    poses = interpolate_poses(pd.pose_all[0], pd.pose_all[1], n_frames)
    H, W = pd.img_res

    video_dir = os.path.join(exp_dir, "eval", "interpolate")
    frame_dir = os.path.join(video_dir, f"{id0:04d}_{id1:04d}")
    normal_dir = frame_dir + "_normal"
    for d in (frame_dir, normal_dir):
        os.makedirs(d, exist_ok=True)

    render_image = make_eval_render_fn(
        model, chunk_size=conf.train.get("split_n_pixels", 12000),
        fused=fused)
    uv = torch.from_numpy(pd.uv).to(device)
    K = torch.from_numpy(pd.intrinsics_all[0]).to(device)
    for i, pose in enumerate(poses):
        t0 = time.perf_counter()
        out = render_image(uv, K, torch.from_numpy(pose).to(device))
        out = {k: v.cpu().numpy() for k, v in out.items()}  # synchronizes
        seconds = time.perf_counter() - t0
        rgb = out["rgb_values"].reshape(H, W, 3)
        imaging.write_png(os.path.join(frame_dir, f"{i:04d}.png"),
                          imaging.to_u8(rgb))
        n_cam = out["normal_map"].reshape(H, W, 3) @ pose[:3, :3]
        imaging.write_png(os.path.join(normal_dir, f"{i:04d}.png"),
                          imaging.to_u8((n_cam + 1.0) / 2.0))
        print(f"[INFO] frame {i:04d}: {seconds:.3f} s")

    name = f"scan{scan_id}_{id0:04d}_{id1:04d}"
    frames_to_video(frame_dir, os.path.join(video_dir, f"{name}.mp4"),
                    frame_rate)
    frames_to_video(normal_dir,
                    os.path.join(video_dir, f"{name}_normal.mp4"),
                    frame_rate)
    return frame_dir
