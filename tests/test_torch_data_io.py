"""The data paths of the last train and eval slice against the JAX
package's loaders on the same files, on the CPU, on the tiny scene of
`test_torch_train_step.py` (two 24 x 32 views of scan1) with:

* HDR images (`hdr/`): `.npy`, and EXR written by the JAX package's
  native writer with the channels stored as B, G, R and as R, G, B
  (`imaging.load_rgb(..., is_hdr=True)` against the JAX `load_rgb`,
  whose reader flips the channels twice);
* object masks (`mask/`, PNG and `.npy`; ones when the folder is
  missing) and depth noise (`noise_scale`, the same
  `default_rng(0)` draws in the same order) through `ReconData`;
* the held-out views (`val/`, `val_mat_i @ scale_mat_0`) and HDR images
  through `PlotData`, with and without `val/`;
* the sRGB curves on numpy arrays.

Arrays that both packages read or compute in f32 the same way must be
equal; the point cloud, which the JAX loader unprojects from the f64
noisy depth and the port from its f32 copy, to 1e-6 (f32 rounding); the
views downsampled by OpenCV's area filter (JAX) and by the port's area
mean to 1e-6.
"""

import os
import shutil

import numpy as np
import pytest

from i2sdf_tpu import native
from i2sdf_tpu.data.plot import PlotData as JPlotData
from i2sdf_tpu.data.recon import ReconData as JReconData
from i2sdf_tpu.utils import imaging as jimaging
from i2sdf_tpu_torch.data.plot import PlotData
from i2sdf_tpu_torch.data.recon import ReconData
from i2sdf_tpu_torch.utils import imaging
from test_torch_train_step import write_tiny_scene


def _hdr(rng, shape=(24, 32, 3)):
    return (rng.uniform(0.0, 4.0, shape) ** 2).astype(np.float32)


def _write_hdr(path, img, fmt):
    """`img` (H, W, 3, RGB) as `fmt`: npy, or EXR with the channels stored
    as B, G, R (`exr_bgr`) or as R, G, B (`exr_rgb`)."""
    if fmt == "npy":
        np.save(path + ".npy", img)
        return path + ".npy"
    names = ["B", "G", "R"] if fmt == "exr_bgr" else ["R", "G", "B"]
    data = img[..., ::-1] if fmt == "exr_bgr" else img
    native.exr_write(path + ".exr", data, names=names, half=False)
    return path + ".exr"


def _io_scene(root, fmt="npy", masks="png", val=True):
    """The tiny scene with `hdr/` (in `fmt`), `mask/` (`png`, `npy` or
    none) and with `val` a `val/` of two HDR views whose cameras are
    views 1 and 0's world matrices."""
    write_tiny_scene(root)
    scan = os.path.join(root, "tiny", "scan0")
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(scan, "hdr"))
    for i in range(2):
        _write_hdr(os.path.join(scan, "hdr", f"{i:04d}"), _hdr(rng), fmt)
    if masks != "none":
        os.makedirs(os.path.join(scan, "mask"))
        for i in range(2):
            m = rng.uniform(size=(24, 32)) > 0.2
            p = os.path.join(scan, "mask", f"{i:04d}")
            if masks == "png":
                imaging.write_png(p + ".png", (m * 255).astype(np.uint8))
            else:
                np.save(p + ".npy", m.astype(np.float32))
    if val:
        os.makedirs(os.path.join(scan, "val"))
        cams = dict(np.load(os.path.join(scan, "cameras_normalize.npz")))
        for j, i in enumerate((1, 0)):
            np.save(os.path.join(scan, "val", f"{j:04d}.npy"), _hdr(rng))
            cams[f"val_mat_{j}"] = cams[f"world_mat_{i}"]
        np.savez(os.path.join(scan, "cameras_normalize.npz"), **cams)
    return scan


@pytest.mark.parametrize("fmt", ["npy", "exr_bgr", "exr_rgb"])
def test_load_rgb_hdr_matches_jax(tmp_path, fmt):
    img = _hdr(np.random.default_rng(1), (5, 7, 3))
    path = _write_hdr(str(tmp_path / "x"), img, fmt)
    got = imaging.load_rgb(path, is_hdr=True)
    np.testing.assert_array_equal(got, jimaging.load_rgb(path, is_hdr=True))
    np.testing.assert_array_equal(got, img)   # RGB, whatever the order
    assert got.dtype == np.float32


def test_srgb_curves_match_jax():
    x = np.linspace(-0.1, 1.5, 257).astype(np.float32)
    for fn, jfn in ((imaging.linear_to_srgb, jimaging.linear_to_srgb),
                    (imaging.srgb_to_linear, jimaging.srgb_to_linear)):
        got = fn(x)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(jfn(x)), rtol=1e-6,
                                   atol=1e-7)
    y = np.linspace(0.0, 1.0, 101).astype(np.float32)
    np.testing.assert_allclose(
        imaging.srgb_to_linear(imaging.linear_to_srgb(y)), y, atol=1e-6)


def _recon_equal(got, ref):
    for name in ("intrinsics_all", "pose_all", "rgb_images", "uv",
                 "mask_images", "depth_images", "depth_masks",
                 "pointlinks", "pixlinks"):
        g, r = getattr(got, name), getattr(ref, name)
        assert (g is None) == (r is None), name
        if g is not None:
            np.testing.assert_array_equal(g, r, err_msg=name)
    if ref.pointcloud is not None:
        np.testing.assert_allclose(got.pointcloud, ref.pointcloud, rtol=1e-6,
                                   atol=1e-6)
    assert got.img_res == ref.img_res and got.n_images == ref.n_images


@pytest.mark.parametrize("fmt,masks,noise", [
    ("npy", "png", 0.0), ("exr_bgr", "npy", 1.0), ("exr_rgb", "none", 2.5)])
def test_recon_data_hdr_masks_noise_match_jax(tmp_path, fmt, masks, noise):
    _io_scene(str(tmp_path), fmt, masks, val=False)
    kw = dict(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
              is_hdr=True, use_mask=True, use_depth=True, use_bubble=True,
              noise_scale=noise)
    got, ref = ReconData(**kw), JReconData(**kw)
    _recon_equal(got, ref)
    assert got.rgb_images.max() > 1.0          # linear, not clipped
    if masks == "none":
        assert (got.mask_images == 1.0).all()
    else:
        assert 0.0 < got.mask_images.mean() < 1.0
    clean = ReconData(**{**kw, "noise_scale": 0.0})
    moved = np.abs(got.depth_images - clean.depth_images)
    assert (moved.max() > 0) == (noise > 0)
    assert (got.depth_masks == clean.depth_masks).all()
    assert (moved[~got.depth_masks] == 0).all()
    d = got.to_device("cpu")
    from i2sdf_tpu_torch.data.recon import sample_batch
    import torch
    _, gt = sample_batch(d, torch.tensor([0, 5, 24 * 32 + 7]))
    assert gt["mask"].shape == (3, 1)


@pytest.mark.parametrize("is_val", [True, False])
def test_plot_data_val_and_hdr_match_jax(tmp_path, is_val):
    _io_scene(str(tmp_path))
    kw = dict(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
              is_val=is_val, is_hdr=True)
    for extra in ({}, {"indices": [1]}, {"downsample": 2}):
        got, ref = PlotData(**kw, **extra), JPlotData(**kw, **extra)
        for name in ("intrinsics_all", "pose_all", "rgb_images", "uv"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(ref, name), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {extra}")
        assert got.img_res == ref.img_res and got.n_images == ref.n_images
    scan = os.path.join(str(tmp_path), "tiny", "scan0")
    view0 = PlotData(**kw, indices=[0]).rgb_images[0].reshape(24, 32, 3)
    want = np.load(os.path.join(scan, "val" if is_val else "hdr",
                                "0000.npy"))
    np.testing.assert_array_equal(view0, want)


def test_plot_data_is_val_without_val_dir_takes_training_views(tmp_path):
    scan = _io_scene(str(tmp_path))
    shutil.rmtree(os.path.join(scan, "val"))
    kw = dict(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
              is_val=True)
    got, ref = PlotData(**kw), JPlotData(**kw)
    np.testing.assert_allclose(got.rgb_images, ref.rgb_images, atol=1e-6)
    np.testing.assert_allclose(got.pose_all, ref.pose_all, atol=1e-6)
    assert got.n_images == ref.n_images == 2


def test_plot_data_ldr_val_matches_jax(tmp_path):
    """Held-out views of an LDR scene: PNGs under `val/`."""
    scan = _io_scene(str(tmp_path))
    shutil.rmtree(os.path.join(scan, "val"))
    os.makedirs(os.path.join(scan, "val"))
    rng = np.random.default_rng(9)
    for j in range(2):
        imaging.write_png(os.path.join(scan, "val", f"{j:04d}.png"),
                          rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    kw = dict(data_dir="tiny", scan_id=0, data_root=str(tmp_path),
              is_val=True)
    got, ref = PlotData(**kw), JPlotData(**kw)
    np.testing.assert_array_equal(got.rgb_images, ref.rgb_images)
    np.testing.assert_allclose(got.pose_all, ref.pose_all, atol=1e-6)
    np.testing.assert_allclose(got.intrinsics_all, ref.intrinsics_all,
                               atol=1e-6)
