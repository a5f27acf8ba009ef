"""Build and load the port's CUDA kernels (`i2sdf_tpu_torch/csrc/*.cu`).

Every source is compiled for `sm_90a` by its own `nvcc -c`, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with `ctypes` (no PyTorch headers, so the build takes
seconds, not minutes). The library lands in
`build/i2sdf_tpu_torch/` beside the package, named by a hash of the
sources and flags: a changed source builds a new file, and a finished
file is never rebuilt. Each object is kept there too (`obj/`), named by a
hash of the flags, its source and the headers it includes, so a library
that differs from a built one in a few sources compiles only those (the
planted faults of `scripts/plant_faults.py` share one build directory).
The compiler writes to temporary names that are renamed into place, so an
interrupted build leaves no lock and no half-written file behind.

Nothing here runs at import: the CPU-only test machine imports every
module of the package and has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "i2sdf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 300

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "i2sdf_sdf_mlp_nograd": [_P, _P, _I, _P, _P, _P, _I, _I, _P],
    "i2sdf_sampler_round": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _F,
                            _F, _I, _P],
    "i2sdf_render_core_fwd": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P,
                              _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "i2sdf_render_core_bwd": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P,
                              _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                              _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I,
                              _P, _P, _P],
    "i2sdf_rev_fwd": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I,
                      _P, _P, _P, _I, _P, _P, _P],
    "i2sdf_rev_bwd": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                      _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
    "i2sdf_conv_check": [_P, _P, _P, _F, _P, _I, _I, _P],
    "i2sdf_bg_core_fwd": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P, _P, _P],
    "i2sdf_bg_core_bwd": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                          _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                          _P, _I, _P, _P, _P],
    "i2sdf_sdf_outputs": [_P, _I, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P,
                          _P],
    "i2sdf_sdf_grad_fwd": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
}
_SIGNATURES["i2sdf_sdf_grad_bwd"] = _SIGNATURES["i2sdf_rev_bwd"]  # K12 is K6

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _closure(src: Path, seen: set) -> set:
    """The headers of `csrc/` that src includes, directly or not."""
    for line in src.read_text().splitlines():
        if line.startswith('#include "'):
            dep = CSRC / line.split('"')[1]
            if dep.exists() and dep not in seen:
                seen.add(dep)
                _closure(dep, seen)
    return seen


def object_path(src: Path) -> Path:
    """Where src's object is kept: named by the flags, src and its
    headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(_closure(src, set()))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / "obj" / f"{src.stem}_{h.hexdigest()[:16]}.o"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libi2sdf_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not there yet: one `nvcc -c` per
    source whose object is not kept yet, run in parallel, then one link.

    Returns (path, seconds spent compiling)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    (BUILD_DIR / "obj").mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [object_path(src) for src in sorted(CSRC.glob("*.cu"))]
    todo = [(src, obj, obj.with_name(f".{tag}.{obj.name}"))
            for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)
            if not obj.exists()]
    tmp = out.with_name(f".{tag}.so.tmp")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    try:
        for src, _, part in todo:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(part), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        deadline = time.monotonic() + BUILD_TIMEOUT_S
        for cmd, proc in procs:
            _, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        for _, obj, part in todo:
            os.replace(part, obj)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *[str(o) for o in objs]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in [*(part for *_, part in todo), tmp]:
            if path.exists():
                path.unlink()
    return out, time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.i2sdf_error_string.argtypes = [ctypes.c_int]
        lib.i2sdf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().i2sdf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
