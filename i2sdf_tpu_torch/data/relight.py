"""Relighting and scene-editing data (counterpart of
`i2sdf_tpu/data/relight.py`): `PlotData` with an edit config's per-pixel
material overrides (`mask`, `normal`, `rough`, `kd`, `ks` image paths),
each read with the port's readers (`normal`, `kd`, `ks` as RGB, HDR for
`.exr` / `.npy`; `mask`, `rough` as grey masks) and resized to the render
size by `imaging.resize_area` (OpenCV's INTER_AREA, which the JAX loader
calls); and `RelightVideoData`, the frames' poses interpolated between two
views (`eval/interpolate.interpolate_poses`).
"""

from __future__ import annotations

import os

import numpy as np

from ..eval.interpolate import interpolate_poses
from ..utils import imaging
from .plot import PlotData

_EDIT_KEYS = ("mask", "normal", "rough", "kd", "ks")


class RelightData(PlotData):
    def __init__(self, *args, edit_conf: dict | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.edits = {}
        if not edit_conf:
            return
        H, W = self.img_res
        for key in _EDIT_KEYS:
            path = edit_conf.get(key)
            if not path or not os.path.exists(path):
                continue
            if key in ("normal", "kd", "ks"):
                img = imaging.load_rgb(path, is_hdr=path.endswith(
                    (".exr", ".npy")))
            else:
                img = imaging.load_mask(path)[..., None]
            self.edits[key] = imaging.resize_area(img, (H, W)).reshape(
                H * W, -1)

    def edited_materials(self, kd, ks, rough, normal, mask=None):
        """The override maps blended over the per-pixel materials by the
        edit mask (all ones without one)."""
        m = self.edits.get("mask")
        if m is None:
            m = np.ones_like(kd[..., :1])
        out = {}
        for name, base in (("kd", kd), ("ks", ks), ("rough", rough),
                           ("normal", normal)):
            override = self.edits.get(name)
            out[name] = (base if override is None
                         else base * (1 - m) + override * m)
        return out


class RelightVideoData(RelightData):
    def __init__(self, *args, id0: int = 0, id1: int = 1,
                 num_frames: int = 60, **kwargs):
        super().__init__(*args, **kwargs)
        self.frame_poses = interpolate_poses(
            self.pose_all[id0], self.pose_all[id1], num_frames)
        self.num_frames = num_frames

    def frame_inputs(self, i: int):
        """Frame i: (uv, the first view's intrinsics, its pose)."""
        return (self.uv, self.intrinsics_all[0], self.frame_poses[i])
