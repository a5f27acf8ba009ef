"""OpenEXR scanline reader in numpy + zlib (counterpart of the JAX
package's native reader, `i2sdf_tpu/native/src/exr.cpp:160-260`, and its
wrapper `i2sdf_tpu/native/__init__.py::exr_read`).

Scope, as the native reader's: single-part scanline images, compression
NONE (0), ZIPS (2, one line a block) or ZIP (3, 16 lines a block), pixel
types UINT, HALF and FLOAT, no subsampling. That covers the scenes' depth
and normal maps (ZIP, FLOAT, channels B, G, R). No OpenCV and no C++
build.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
_NONE, _ZIPS, _ZIP = 0, 2, 3
_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_CANONICAL = ("R", "G", "B", "A")


def _cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _channels(value: bytes) -> list[tuple[str, int]]:
    out, pos = [], 0
    while value[pos] != 0:
        name, pos = _cstr(value, pos)
        ptype, _, xs, ys = struct.unpack_from("<iI ii", value, pos)
        pos += 16
        if ptype not in _DTYPES or (xs, ys) != (1, 1):
            raise ValueError(f"EXR channel {name!r}: pixel type {ptype} or "
                             "subsampling not supported")
        out.append((name, ptype))
    return out


def _unzip(data: bytes, size: int) -> bytes:
    """ZIP(S) block: inflate, undo the delta predictor, re-interleave the
    two byte halves."""
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    if raw.size != size:
        raise ValueError("EXR block inflates to the wrong size")
    t = ((np.cumsum(raw.astype(np.int64) - 128) + 128) & 0xFF).astype(
        np.uint8)
    out = np.empty_like(t)
    half = (size + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(path: str) -> tuple[np.ndarray, list[str]]:
    """(data, names): float32 (H, W) for a single channel, else (H, W, C)
    in canonical order (R, G, B, A where the channels are among those,
    else the file's alphabetical order), with the matching names."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<Ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    if version & (0x200 | 0x800 | 0x1000):
        raise ValueError(f"{path}: tiled, deep or multi-part EXR is not "
                         "supported")
    pos, chans, comp, window = 8, None, None, None
    while True:
        name, pos = _cstr(buf, pos)
        if not name:
            break
        typ, pos = _cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        value = buf[pos:pos + size]
        pos += size
        if name == "channels" and typ == "chlist":
            chans = _channels(value)
        elif name == "compression" and typ == "compression":
            comp = value[0]
        elif name == "dataWindow" and typ == "box2i":
            window = struct.unpack("<4i", value)
    if not chans or window is None or comp not in (_NONE, _ZIPS, _ZIP):
        raise ValueError(f"{path}: compression {comp} or header not "
                         "supported")
    xmin, ymin, xmax, ymax = window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lines = 16 if comp == _ZIP else 1
    n_blocks = (h + lines - 1) // lines
    offsets = np.frombuffer(buf, "<u8", n_blocks, pos)
    line_bytes = [w * _DTYPES[t].itemsize for _, t in chans]
    out = np.empty((h, w, len(chans)), np.float32)
    for off in offsets:
        y0, size = struct.unpack_from("<ii", buf, int(off))
        y0 -= ymin
        n = min(lines, h - y0)
        want = n * sum(line_bytes)
        data = buf[int(off) + 8:int(off) + 8 + size]
        if comp != _NONE and size < want:
            data = _unzip(data, want)
        p = 0
        for ln in range(n):
            for c, (_, t) in enumerate(chans):
                out[y0 + ln, :, c] = np.frombuffer(data, _DTYPES[t], w, p)
                p += line_bytes[c]
    names = [n for n, _ in chans]
    if len(names) > 1 and set(names) <= set(_CANONICAL):
        order = sorted(range(len(names)),
                       key=lambda i: _CANONICAL.index(names[i]))
        out, names = out[:, :, order], [names[i] for i in order]
    if len(names) == 1:
        return out[:, :, 0], names
    return out, names
