"""The port's host-side IO: its own YAML loader, PNG codec and area
downsampling (held to PyYAML and OpenCV), its metrics (held to the JAX
package's), and a guard that the package (the training slice's modules
by name) and `chip_smoke.py` import none of JAX, the JAX package,
OpenCV, imageio, PIL, orbax or PyYAML."""

import glob
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import cv2
import numpy as np
import pytest
import yaml

from i2sdf_tpu.utils import imaging as jimaging
from i2sdf_tpu_torch.config import CfgNode, load_cfg
from i2sdf_tpu_torch.config.cfgnode import parse_yaml
from i2sdf_tpu_torch.utils import imaging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_IMG = os.path.join(ROOT, "data", "synthetic_quality", "scan1", "image",
                         "0000.png")


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "configs", "*.yml"))), ids=os.path.basename)
def test_yaml_subset_equals_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_yaml_scalars_and_refusals():
    text = textwrap.dedent("""\
        a: 1.0e-4        # PyYAML: 1.0e-4 is a float ...
        b: 1e-4          # ... and 1e-4 a string
        c: [1, 'x', true, null, ~]
        d:
          e: "q # not a comment"
          f:
        g: -3
        """)
    assert parse_yaml(text) == yaml.safe_load(text)
    for bad in ("a:\n  - 1\n", "a: {b: 1}\n", "a: &x 1\n", "a: [[1]]\n"):
        with pytest.raises(ValueError):
            parse_yaml(bad)


def test_cfgnode_behaviour(tmp_path):
    p = tmp_path / "c.yml"
    p.write_text("train:\n  steps: 10\n  lr: 0.5\nmodel:\n  dims: [4, 4]\n")
    cfg = load_cfg(str(p))
    assert cfg.train.steps == 10 and cfg.model.dims == [4, 4]
    assert cfg.train.get("nope", 3) == 3 and "lr" in cfg.train
    with pytest.raises(AttributeError):
        cfg.train.nope
    cfg.extra = {"k": 1}
    assert isinstance(cfg.extra, CfgNode) and cfg.extra.k == 1
    with pytest.raises(ValueError):
        cfg.bad = object()


def _encode_png(img: np.ndarray, ftype: int) -> bytes:
    """A PNG whose every row uses filter `ftype` (0..4), encoded here so
    the decoder meets all five filters."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_all_filters(tmp_path, ftype, channels):
    img = np.random.default_rng(ftype).integers(
        0, 256, (13, 17, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, ftype))
    np.testing.assert_array_equal(imaging.read_png(str(path)), img)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    ref = ref[..., None] if ref.ndim == 2 else ref
    if channels >= 3:  # OpenCV's BGR(A) order
        ref = ref[..., [2, 1, 0] + ([3] if channels == 4 else [])]
    np.testing.assert_array_equal(imaging.read_png(str(path)), ref)


def test_png_scene_image_and_writer_match_opencv(tmp_path):
    img = imaging.read_png(SCENE_IMG)
    np.testing.assert_array_equal(img, cv2.imread(SCENE_IMG)[:, :, ::-1])
    path = str(tmp_path / "w.png")
    imaging.write_png(path, img[::7, ::5])
    np.testing.assert_array_equal(cv2.imread(path)[:, :, ::-1], img[::7, ::5])
    gray = img[..., 0]
    imaging.write_png(path, gray)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  gray)


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_matches_opencv_area(factor):
    img = imaging.load_rgb(SCENE_IMG)
    H, W = img.shape[:2]
    ref = cv2.resize(img, (W // factor, H // factor),
                     interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(imaging.downsample_area(img, factor), ref,
                               atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(40, 56, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    assert imaging.psnr(a, b) == pytest.approx(float(jimaging.psnr(a, b)),
                                               abs=1e-4)
    assert imaging.ssim(a, b) == pytest.approx(
        float(jimaging.ssim(a[None], b[None])), abs=1e-5)
    x = np.linspace(0, 1, 101, dtype=np.float32)
    import torch
    np.testing.assert_allclose(
        imaging.linear_to_srgb(torch.from_numpy(x)).numpy(),
        np.asarray(jimaging.linear_to_srgb(x)), atol=1e-6)


GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "i2sdf_tpu", "orbax", "cv2", "imageio", "PIL",
           "yaml"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import i2sdf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(i2sdf_tpu_torch.__path__,
                                                "i2sdf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = {"i2sdf_tpu_torch.utils.exr", "i2sdf_tpu_torch.data.recon",
           "i2sdf_tpu_torch.models.losses", "i2sdf_tpu_torch.train.state",
           "i2sdf_tpu_torch.train.step", "i2sdf_tpu_torch.train.checkpoint",
           "i2sdf_tpu_torch.train.trainer",
           "i2sdf_tpu_torch.ops.kernels.conv_check",
           "i2sdf_tpu_torch.ops.kernels.bg_core"} - set(names)
assert not missing, missing
import chip_smoke
print(len(names), "modules")
"""


def test_port_imports_nothing_the_card_may_lack():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 39
