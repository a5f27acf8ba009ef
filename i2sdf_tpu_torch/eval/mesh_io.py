"""Triangle-mesh IO and sampling (host-side, numpy): a copy of
`i2sdf_tpu/eval/mesh_io.py`, kept in the port so that it imports nothing
of the JAX package.

Replaces the trimesh usages of the reference (`utils/plots.py:219`,
`model/eval/recon.py:61-63,106`): binary-PLY export/import,
area-weighted surface sampling (seeded `default_rng(0)`, as in the JAX
package, so both draw the same samples), and scale_mat application.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY; `colors` (N, 3) in [0, 1] adds uchar
    per-vertex RGB (`--use_material` bakes the learned albedo so)."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    color_props = ""
    if colors is not None:
        assert len(colors) == len(verts), (len(colors), len(verts))
        color_props = ("property uchar red\nproperty uchar green\n"
                       "property uchar blue\n")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"{color_props}"
        f"element face {len(tris)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if colors is None:
            f.write(verts.astype("<f4").tobytes())
        else:
            rgb = np.clip(np.asarray(colors, np.float32) * 255.0 + 0.5,
                          0, 255).astype(np.uint8)
            vrec = np.zeros(len(verts),
                            dtype=[("p", "<f4", (3,)), ("c", "u1", (3,))])
            vrec["p"] = verts
            vrec["c"] = rgb
            f.write(vrec.tobytes())
        # uint8 count + 3x int32 per face, as a packed structured array
        rec = np.zeros(len(tris), dtype=[("n", "u1"), ("v", "<i4", (3,))])
        rec["n"] = 3
        rec["v"] = tris
        f.write(rec.tobytes())


def read_ply(path: str):
    """Minimal binary/ascii PLY reader (positions + faces)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vert = n_face = 0
        fmt = "binary_little_endian"
        props = []  # (ply_type, name) per vertex property
        elem = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elem = parts[1]
                if elem == "vertex":
                    n_vert = int(parts[2])
                elif elem == "face":
                    n_face = int(parts[2])
            elif parts[0] == "property" and elem == "vertex":
                props.append((parts[1], parts[-1]))
        if fmt == "ascii":
            verts = np.loadtxt(f, max_rows=n_vert).reshape(n_vert, -1)
            faces = np.loadtxt(f, max_rows=n_face).astype(np.int64)
            return (verts[:, :3].astype(np.float32),
                    faces[:, 1:4].astype(np.int32))
        ply_np = {"float": "<f4", "float32": "<f4", "double": "<f8",
                  "uchar": "u1", "uint8": "u1", "char": "i1",
                  "short": "<i2", "ushort": "<u2",
                  "int": "<i4", "int32": "<i4", "uint": "<u4"}
        vdtype = np.dtype([(name, ply_np[t]) for t, name in props])
        vdata = np.frombuffer(f.read(n_vert * vdtype.itemsize),
                              dtype=vdtype)
        verts = np.stack([vdata[n].astype(np.float32)
                          for n in ("x", "y", "z")], axis=-1)
        rec = np.frombuffer(
            f.read(n_face * (1 + 12)),
            dtype=[("n", "u1"), ("v", "<i4", (3,))])
        return verts, rec["v"].astype(np.int32).copy()


def triangle_areas(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    v0, v1, v2 = (verts[tris[:, i]] for i in range(3))
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)


def sample_surface(verts: np.ndarray, tris: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (trimesh.sample parity)."""
    rng = np.random.default_rng(seed)
    areas = triangle_areas(verts, tris)
    total = areas.sum()
    if total <= 0 or len(tris) == 0:
        raise ValueError("degenerate mesh: zero surface area")
    probs = areas / total
    idx = rng.choice(len(tris), size=n, p=probs)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    v0, v1, v2 = (verts[tris[idx, i]] for i in range(3))
    return (v0 + u[:, None] * (v1 - v0) + v[:, None] * (v2 - v0)).astype(
        np.float32)


def transform_verts(verts: np.ndarray, mat4: np.ndarray) -> np.ndarray:
    """Apply a 4x4 to (N, 3) vertices."""
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=1)
    out = vh @ np.asarray(mat4, np.float32).T
    return out[:, :3] / out[:, 3:]
