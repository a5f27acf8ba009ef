"""ctypes bindings for the port's host-side C++ mesh tools (counterpart of
`i2sdf_tpu/native/__init__.py`, less its EXR codec: the port reads and
writes EXR in `utils/exr.py`).

The sources in `src/` are the JAX package's, built with its flags, so
the two libraries give the same bits: marching tetrahedra (for skimage's
marching cubes), KD-tree nearest neighbours (sklearn), TSDF fusion
(open3d) and a depth rasterizer (pyrender). The library is built at
first use with the host compiler into `build/i2sdf_tpu_torch/` beside
the package, named by a hash of the sources and flags (as
`ops/kernels/build.py` names the kernels' library): a finished file is
never rebuilt, and the compiler writes to a temporary name that is
renamed into place, so processes that build it at once do not clash. A
failed build raises; there is no Python fallback. Nothing is built at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "i2sdf_tpu_torch"
SOURCES = ("marching.cpp", "kdtree.cpp", "tsdf.cpp", "raster.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in (*SOURCES, "common.h"):
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libi2sdf_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not there yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.so.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp),
           *[str(SRC_DIR / s) for s in SOURCES]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int32)

    lib.i2sdf_free.argtypes = [ctypes.c_void_p]
    lib.i2sdf_free.restype = None

    lib.i2sdf_marching_tetrahedra.restype = ctypes.c_int
    lib.i2sdf_marching_tetrahedra.argtypes = [
        c_fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(c_fp), ctypes.POINTER(c_ip),
        c_ip, c_ip,
    ]

    lib.i2sdf_nn_distances.restype = ctypes.c_int
    lib.i2sdf_nn_distances.argtypes = [
        c_fp, ctypes.c_int32, c_fp, ctypes.c_int32, c_fp]

    lib.i2sdf_tsdf_integrate.restype = ctypes.c_int
    lib.i2sdf_tsdf_integrate.argtypes = [
        c_fp, c_fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        c_fp, ctypes.c_int, ctypes.c_int, c_fp, c_fp,
        ctypes.c_float, ctypes.c_float,
    ]
    lib.i2sdf_tsdf_mask_unobserved.restype = None
    lib.i2sdf_tsdf_mask_unobserved.argtypes = [
        c_fp, c_fp, ctypes.c_int64, ctypes.c_float]

    lib.i2sdf_rasterize_depth.restype = ctypes.c_int
    lib.i2sdf_rasterize_depth.argtypes = [
        c_fp, ctypes.c_int32, c_ip, ctypes.c_int32, c_fp, c_fp,
        ctypes.c_int, ctypes.c_int, c_fp,
    ]


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def marching_cubes(grid, level: float = 0.0, origin=(0.0, 0.0, 0.0),
                   spacing=(1.0, 1.0, 1.0)):
    """Extract the `level` isosurface of a dense (nx, ny, nz) grid.

    Returns (verts (V, 3) float32 world coords, tris (T, 3) int32).
    """
    lib = get_lib()
    grid = _as_f32(grid)
    nx, ny, nz = grid.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int32()
    nt = ctypes.c_int32()
    rc = lib.i2sdf_marching_tetrahedra(
        _fp(grid), nx, ny, nz, level,
        float(origin[0]), float(origin[1]), float(origin[2]),
        float(spacing[0]), float(spacing[1]), float(spacing[2]),
        ctypes.byref(verts_p), ctypes.byref(tris_p),
        ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError("marching tetrahedra failed")
    try:
        verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tris_p, (nt.value, 3)).copy()
    finally:
        lib.i2sdf_free(verts_p)
        lib.i2sdf_free(tris_p)
    return verts, tris


def nn_distances(ref, query) -> np.ndarray:
    """Distance from each query point to its nearest ref point (KD-tree)."""
    lib = get_lib()
    ref = _as_f32(ref).reshape(-1, 3)
    query = _as_f32(query).reshape(-1, 3)
    out = np.empty(query.shape[0], np.float32)
    rc = lib.i2sdf_nn_distances(_fp(ref), ref.shape[0], _fp(query),
                                query.shape[0], _fp(out))
    if rc != 0:
        raise RuntimeError("nn_distances failed (empty reference?)")
    return out


class TSDFVolume:
    """Dense TSDF fusion volume (voxel_size, sdf_trunc as in the
    reference's refuse: 0.01 / 0.05 world units, mesh_util.py:93-97)."""

    def __init__(self, origin, dims, voxel_size: float,
                 sdf_trunc: float = 0.05, depth_max: float = 10.0):
        self.origin = np.asarray(origin, np.float32)
        self.dims = tuple(int(d) for d in dims)
        self.voxel_size = float(voxel_size)
        self.sdf_trunc = float(sdf_trunc)
        self.depth_max = float(depth_max)
        n = self.dims[0] * self.dims[1] * self.dims[2]
        self.tsdf = np.zeros(n, np.float32)
        self.weight = np.zeros(n, np.float32)

    def integrate(self, depth, K, w2c) -> None:
        lib = get_lib()
        depth = _as_f32(depth)
        K33 = _as_f32(np.asarray(K)[:3, :3])
        w2c44 = _as_f32(np.asarray(w2c)[:4, :4])
        h, w = depth.shape
        rc = lib.i2sdf_tsdf_integrate(
            _fp(self.tsdf), _fp(self.weight),
            self.dims[0], self.dims[1], self.dims[2],
            float(self.origin[0]), float(self.origin[1]),
            float(self.origin[2]), self.voxel_size,
            _fp(depth), h, w, _fp(K33), _fp(w2c44),
            self.sdf_trunc, self.depth_max)
        if rc != 0:
            raise RuntimeError("tsdf integrate failed")

    def extract_mesh(self):
        lib = get_lib()
        grid = self.tsdf.copy()
        # unobserved voxels become NaN: marching skips cells touching them
        lib.i2sdf_tsdf_mask_unobserved(
            _fp(grid), _fp(self.weight), grid.size, np.float32(np.nan))
        return marching_cubes(grid.reshape(self.dims), 0.0,
                              origin=self.origin,
                              spacing=(self.voxel_size,) * 3)


def rasterize_depth(verts, tris, K, w2c, h: int, w: int) -> np.ndarray:
    """Z-buffer depth render of a mesh from an OpenCV-convention camera."""
    lib = get_lib()
    verts = _as_f32(verts).reshape(-1, 3)
    tris = _as_i32(tris).reshape(-1, 3)
    K33 = _as_f32(np.asarray(K)[:3, :3])
    w2c44 = _as_f32(np.asarray(w2c)[:4, :4])
    out = np.empty((h, w), np.float32)
    rc = lib.i2sdf_rasterize_depth(
        _fp(verts), verts.shape[0], _ip(tris), tris.shape[0],
        _fp(K33), _fp(w2c44), h, w, _fp(out))
    if rc != 0:
        raise RuntimeError("rasterize failed")
    return out
