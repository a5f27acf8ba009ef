"""Image IO and metrics (counterpart of `i2sdf_tpu/utils/imaging.py`).

PNG files are read and written with the standard library's `zlib` and
numpy alone (8-bit gray, RGB or RGBA, not interlaced): the machine the
port runs on is not promised OpenCV, imageio or PIL. EXR depth and normal
maps are read by `utils/exr.py`, and `.npy` is accepted wherever an EXR
is (`load_depth`, `load_normal`); masks are PNG or `.npy`
(`load_mask`); HDR images (`load_rgb(..., is_hdr=True)`) `.npy` or EXR,
in RGB order as the JAX loader gives them. Downsampling is an area mean
over exact integer factors (what OpenCV's INTER_AREA computes there);
`resize_area` is INTER_AREA between any two sizes (the relight edit
maps').
PSNR, SSIM and the sRGB curves follow the reference's definitions; the
sRGB curves take numpy arrays or torch tensors.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from .exr import read_exr

IMG_EXTENSIONS = (".png", ".exr", ".npy")
HDR_EXTENSIONS = (".exr", ".npy")
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG color type -> channels


def glob_imgs(path: str, exts: tuple = IMG_EXTENSIONS) -> list[str]:
    """Sorted files of a directory with these extensions; [] if it is
    missing."""
    if not os.path.isdir(path):
        return []
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(exts))


def _read_float(path: str) -> np.ndarray:
    """`.npy` as stored; EXR with R, G, B channels in B, G, R order (the
    reference's cv2 convention, `i2sdf_tpu/utils/imaging.py:36-45`)."""
    if path.endswith(".npy"):
        return np.load(path)
    data, names = read_exr(path)
    if data.ndim == 3 and set(names[:3]) == {"R", "G", "B"}:
        data = data[:, :, ::-1].copy()
    return data


def load_depth(path: str) -> np.ndarray:
    """Depth map as float32 (H, W): an EXR's last channel in B, G, R
    order (R), a single-channel EXR, or `.npy`."""
    img = np.asarray(_read_float(path), dtype=np.float32)
    return img[:, :, -1] if img.ndim == 3 else img


def load_normal(path: str) -> np.ndarray:
    """Normal map as float32 (H, W, 3) in R, G, B order."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    img = np.asarray(_read_float(path), dtype=np.float32)
    return img[:, :, ::-1].copy()


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential in x
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    ul = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = (left if pa <= pb and pa <= pc
                            else up[i] if pb <= pc else ul)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """8-bit PNG -> uint8 (H, W, C) with C in {1, 3, 4}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced gray/RGB/RGBA "
                         f"PNGs are supported (depth {depth}, color type "
                         f"{ctype}, interlace {interlace})")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 (H, W), (H, W, 3) or (H, W, 4) -> PNG (filter type 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * c)], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def load_rgb(path: str, is_hdr: bool = False) -> np.ndarray:
    """An image as float32 (H, W, 3): an 8-bit PNG in [0, 1]; `.npy` as
    stored; with `is_hdr` an EXR's channels in R, G, B order (linear), as
    `i2sdf_tpu/utils/imaging.py:64-80` gives them: its reader's B, G, R
    order (`_read_float`) turned back, whatever order the file stores
    them in."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if is_hdr:
        img = _read_float(path).astype(np.float32)
        if img.ndim == 3 and img.shape[2] >= 3:
            img = img[:, :, :3][:, :, ::-1].copy()
        return img
    img = read_png(path).astype(np.float32) / 255.0
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return img[:, :, :3]


def load_mask(path: str) -> np.ndarray:
    """Single-channel mask as float32 (H, W): `.npy` as stored, an 8-bit
    PNG's first channel scaled to [0, 1] when its maximum is above 1.5 (a
    0/1 mask stays as it is), as `i2sdf_tpu/utils/imaging.py:83-95`."""
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
    else:
        img = read_png(path).astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
    if img.ndim == 3:
        img = img[:, :, 0]
    return img.astype(np.float32)


def to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def downsample_area(img: np.ndarray, factor: int) -> np.ndarray:
    """(H, W, C) -> (H/f, W/f, C) mean over f x f blocks; H and W must be
    multiples of f."""
    if factor <= 1:
        return img
    H, W = img.shape[:2]
    if H % factor or W % factor:
        raise ValueError(f"image {H}x{W} is not a multiple of {factor}")
    h, w = H // factor, W // factor
    blocks = img.reshape(h, factor, w, factor, -1).astype(np.float64)
    return blocks.mean(axis=(1, 3)).astype(img.dtype).reshape(
        h, w, *img.shape[2:])


def _area_weights(src: int, dst: int, area: bool) -> np.ndarray:
    """(dst, src) weights of one axis of OpenCV's INTER_AREA: with `area`
    (both axes shrink) each output cell's overlap with the inputs
    (`computeResizeAreaTab`), else its linear emulation (`resize`'s
    `area_mode` taps: input floor(d * scale) and the next, the second
    weighted by the fractional part of (d + 1) - (s + 1) * dst / src)."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        if area:
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, src - f1)
            s2 = min(math.floor(f2), src - 1)
            s1 = min(math.ceil(f1), s2)
            if s1 - f1 > 1e-3:
                w[d, s1 - 1] = np.float32((s1 - f1) / cell)
            w[d, s1:s2] = np.float32(1.0 / cell)
            if f2 - s2 > 1e-3:
                w[d, s2] = np.float32(min(f2 - s2, 1.0, cell) / cell)
        else:
            s = math.floor(d * scale)
            f = float(np.float32((d + 1) - (s + 1) * (dst / src)))
            f = 0.0 if f <= 0 else f - math.floor(f)
            if s >= src - 1:
                s, f = src - 1, 0.0
            w[d, s] += np.float32(1.0 - f)
            w[d, min(s + 1, src - 1)] += np.float32(f)
    return w


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """(H, W[, C]) -> (h, w[, C]) as `cv2.resize(img, (w, h),
    interpolation=cv2.INTER_AREA)` gives it, for any sizes: area means
    where both axes shrink, OpenCV's linear emulation of them where one
    grows (whole-pixel replication at integer factors), float32."""
    h, w = size
    H, W = img.shape[:2]
    area = H >= h and W >= w
    wy, wx = _area_weights(H, h, area), _area_weights(W, w, area)
    x = np.asarray(img, np.float64).reshape(H, W, -1)
    rows = np.tensordot(wy, x, axes=(1, 0))            # (h, W, C)
    out = np.tensordot(wx, rows, axes=(1, 1))          # (w, h, C)
    return out.transpose(1, 0, 2).astype(np.float32).reshape(
        (h, w) + img.shape[2:])


def linear_to_srgb(x):
    """The sRGB curve (`i2sdf_tpu/utils/imaging.py:207-211`) of a tensor,
    or of a numpy array (float32 for a float32 array)."""
    if isinstance(x, torch.Tensor):
        return torch.where(x <= 0.0031308, x * 12.92,
                           1.055 * x.abs() ** (1 / 2.4) - 0.055)
    x = np.asarray(x)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.abs(x) ** (1 / 2.4) - 0.055).astype(x.dtype)


def srgb_to_linear(x):
    """Its inverse (`i2sdf_tpu/utils/imaging.py:213-216`)."""
    if isinstance(x, torch.Tensor):
        return torch.where(x <= 0.04045, x / 12.92,
                           ((x + 0.055) / 1.055) ** 2.4)
    x = np.asarray(x)
    with np.errstate(invalid="ignore"):   # the branch not taken, x < 0
        return np.where(x <= 0.04045, x / 12.92,
                        ((x + 0.055) / 1.055) ** 2.4).astype(x.dtype)


def psnr(img1, img2) -> float:
    """PSNR of [0, 1] images."""
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32)
    mse = torch.mean((a - b) ** 2)
    return float(-10.0 * torch.log10(mse))


def ssim(img1, img2, max_val: float = 1.0) -> float:
    """SSIM of (H, W, C) images: per-channel 11-tap Gaussian window
    (sigma 1.5, valid region), standard constants."""
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    coords = torch.arange(11, dtype=torch.float32) - 5.0
    g = torch.exp(-coords ** 2 / (2.0 * 1.5 ** 2))
    g = g / g.sum()

    def filt(x):
        x = x.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
        x = F.conv2d(x, g.reshape(1, 1, 11, 1))
        return F.conv2d(x, g.reshape(1, 1, 1, 11))

    mu1, mu2 = filt(a), filt(b)
    s11 = filt(a * a) - mu1 ** 2
    s22 = filt(b * b) - mu2 ** 2
    s12 = filt(a * b) - mu1 * mu2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 ** 2 + mu2 ** 2 + c1) * (s11 + s22 + c2)
    return float(torch.clamp(num / den, -1.0, 1.0).mean())
