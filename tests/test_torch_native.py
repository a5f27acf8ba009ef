"""The port's host C++ mesh tools (`i2sdf_tpu_torch/native/`) against the
JAX package's (`i2sdf_tpu/native/`) on the same grids, points, depths and
meshes. Both libraries are built from the same sources with the same
flags, so every result must be equal to the bit. Also: the port builds
its library into `build/` under a hash of its sources and flags, a
failed build raises, and builds that race leave one whole library.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from i2sdf_tpu import native as jnative
from i2sdf_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sphere_grid(n=40, r=0.6, extent=1.0, seed=None):
    xs = np.linspace(-extent, extent, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    grid = (np.sqrt(X**2 + 0.7 * Y**2 + 1.3 * Z**2) - r).astype(np.float32)
    if seed is not None:  # bumps, and cells marching must skip
        rng = np.random.default_rng(seed)
        grid += 0.02 * rng.normal(size=grid.shape).astype(np.float32)
        grid[rng.uniform(size=grid.shape) < 0.01] = np.nan
    return grid, (-extent,) * 3, (xs[1] - xs[0],) * 3


def _camera(ang, radius=2.0):
    c, s = np.cos(ang), np.sin(ang)
    eye = np.array([radius * c, 0.3, radius * s], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return np.linalg.inv(c2w).astype(np.float32)


K = np.array([[70.0, 0, 40], [0, 70.0, 30], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("level", [0.0, 0.15])
@pytest.mark.parametrize("seed", [None, 3], ids=["smooth", "noisy"])
def test_marching_cubes_equals_jax(seed, level):
    grid, origin, spacing = _sphere_grid(seed=seed)
    v, t = native.marching_cubes(grid, level, origin, spacing)
    jv, jt = jnative.marching_cubes(grid, level, origin, spacing)
    assert len(t) > 1000
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


def test_nn_distances_equal_jax_and_brute_force():
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(3000, 3)).astype(np.float32)
    q = rng.normal(size=(700, 3)).astype(np.float32)
    d = native.nn_distances(ref, q)
    np.testing.assert_array_equal(d, jnative.nn_distances(ref, q))
    brute = np.sqrt(((q[:, None] - ref[None]) ** 2).sum(-1)).min(1)
    np.testing.assert_allclose(d, brute, rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError):
        native.nn_distances(np.zeros((0, 3), np.float32), q)


def test_rasterize_depth_equals_jax():
    grid, origin, spacing = _sphere_grid()
    verts, tris = native.marching_cubes(grid, 0.0, origin, spacing)
    for ang in (0.0, 1.3, 4.0):
        w2c = _camera(ang)
        d = native.rasterize_depth(verts, tris, K, w2c, 60, 80)
        assert (d > 0).sum() > 500
        np.testing.assert_array_equal(
            d, jnative.rasterize_depth(verts, tris, K, w2c, 60, 80))


def test_tsdf_volume_equals_jax():
    """Three depth renders fused into both libraries' volumes: the same
    TSDF, weights and extracted mesh."""
    grid, origin, spacing = _sphere_grid(n=32)
    verts, tris = native.marching_cubes(grid, 0.0, origin, spacing)
    kw = dict(origin=(-1.0, -0.9, -1.1), dims=(40, 44, 48),
              voxel_size=0.05, sdf_trunc=0.15, depth_max=4.0)
    vol, jvol = native.TSDFVolume(**kw), jnative.TSDFVolume(**kw)
    for ang in (0.2, 2.2, 4.2):
        w2c = _camera(ang)
        depth = native.rasterize_depth(verts, tris, K, w2c, 60, 80)
        vol.integrate(depth, K, w2c)
        jvol.integrate(depth, K, w2c)
    np.testing.assert_array_equal(vol.tsdf, jvol.tsdf.reshape(-1))
    np.testing.assert_array_equal(vol.weight, jvol.weight)
    v, t = vol.extract_mesh()
    jv, jt = jvol.extract_mesh()
    assert len(t) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


def test_library_builds_into_build_dir_by_hash():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path == native.library_path() and path.is_file()
    assert os.path.commonpath([path, os.path.join(ROOT, "build")]) == \
        os.path.join(ROOT, "build")
    assert not any(f.endswith(".so") for f in os.listdir(native.SRC_DIR))
    assert native.get_lib()._name == str(path)


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in (*native.SOURCES, "common.h"):
        (src / name).write_text("#error planted\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").iterdir())  # no half-written file


RACE = textwrap.dedent("""
    import sys
    from pathlib import Path
    from i2sdf_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[1])
    lib = native.get_lib()
    v, t = native.marching_cubes(
        [[[-1.0, 1.0], [1.0, 1.0]], [[1.0, 1.0], [1.0, 1.0]]])
    print(native.library_path().name, len(t))
""")


def test_racing_builds_leave_one_library(tmp_path):
    """Three processes build the library into one empty directory at
    once (as pytest-xdist workers do): each loads a whole library, and
    one file and no temporary is left."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", RACE, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0] for o in outs}) == 1
    assert sorted(os.listdir(tmp_path)) == [native.library_path().name]
