"""OpenEXR scanline reader and writer in numpy + zlib (counterpart of the
JAX package's native codec, `i2sdf_tpu/native/src/exr.cpp`, and its
wrappers `i2sdf_tpu/native/__init__.py::exr_read`, `exr_write`).

The reader's scope, as the native reader's: single-part scanline images,
compression NONE (0), ZIPS (2, one line a block) or ZIP (3, 16 lines a
block), pixel types UINT, HALF and FLOAT, no subsampling. That covers the
scenes' depth and normal maps (ZIP, FLOAT, channels B, G, R). The writer
writes what the JAX relight writes (`exr_write(..., half=False)`): ZIP,
FLOAT, the same bytes. No OpenCV and no C++ build.
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


def _zip(raw: bytes) -> bytes:
    """ZIP block: split the bytes into their even and odd halves, apply
    the delta predictor, deflate at zlib's default level (the inverse of
    `_unzip`, as `native/src/exr.cpp::zip_preprocess` and `compress2`)."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    t[1:] = (np.diff(t) + 128) & 0xFF
    return zlib.compress(t.astype(np.uint8).tobytes(), -1)


def write_exr(path: str, data: np.ndarray, names=None) -> None:
    """Write float32 (H, W) or (H, W, C) data as a scanline EXR with ZIP
    compression (16 lines a block) and FLOAT pixels: the bytes of the JAX
    package's `native.exr_write(path, data, names, half=False)`. Channels
    default to Y for one, else R, G, B, A (C{i} past four), and are stored
    in the alphabetical order EXR requires; a block whose deflated size is
    not below its raw size is stored raw. Raises on any failure."""
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, c = data.shape
    if h <= 0 or w <= 0 or not 0 < c <= 16:
        raise ValueError(f"EXR write: shape {data.shape} not supported")
    if names is None:
        names = (["Y"] if c == 1 else ["R", "G", "B", "A"][:c] if c <= 4
                 else [f"C{i}" for i in range(c)])
    names = list(names) + [f"C{i}" for i in range(len(names), c)]
    order = sorted(range(c), key=lambda i: names[i])

    def attr(name: str, typ: str, value: bytes) -> bytes:
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    chlist = b"".join(names[i].encode() + b"\0" + struct.pack("<iI ii", 2, 0,
                                                              1, 1)
                      for i in order) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<Ii", MAGIC, 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([_ZIP]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    lines = 16
    n_blocks = (h + lines - 1) // lines
    # (H, C, W) little-endian: a scanline is each channel's row in turn
    planar = data[:, :, order].transpose(0, 2, 1).astype("<f4")
    pos = len(header) + 8 * n_blocks
    offsets, blocks = [], []
    for b in range(n_blocks):
        raw = planar[b * lines:(b + 1) * lines].tobytes()
        packed = _zip(raw)
        payload = packed if len(packed) < len(raw) else raw
        offsets.append(pos)
        blocks.append(struct.pack("<ii", b * lines, len(payload)) + payload)
        pos += len(blocks[-1])
    with open(path, "wb") as f:
        f.write(header + np.asarray(offsets, "<u8").tobytes()
                + b"".join(blocks))
