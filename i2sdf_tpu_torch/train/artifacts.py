"""Visualization artifacts (counterpart of `i2sdf_tpu/train/artifacts.py`):
the colormapped plots (`write_colormap`: the light mask), the bubble's
hot and count maps (`write_hotmaps`, `write_countmaps`: the point-cloud
pdf and the sample counts scattered back to each training image's
pixels, `artifacts.py:62-88` there), the self-contained point-cloud viewer
(`write_pointcloud_html`, `:269-279`) and the mesh viewer
(`write_mesh_html`, a mesh and its cameras' frusta, which `--test_mode
mesh` and the trainer's `--val_mesh` write beside each PLY).

The JAX module takes OpenCV's MAGMA colormap; the port takes the same
table as a numpy constant (`utils/colormap.py`), so its PNGs decode to
the JAX package's pixels, and writes them with `utils/imaging.py`.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.colormap import apply_colormap
from ..utils.imaging import write_png


def _u8(values: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(values), 0, 1) * 255).astype(np.uint8)


def write_colormap(path: str, values: np.ndarray) -> None:
    """(H, W) values in [0, 1] -> a MAGMA PNG."""
    write_png(path, apply_colormap(_u8(values)))


def write_hotmaps(out_dir: str, pdf: np.ndarray, pixlinks: np.ndarray,
                  n_images: int, img_res, step: int | None = None,
                  trace_idx: int = -1, trace_dir: str | None = None,
                  suffix: str = "hot") -> None:
    """The point-cloud pdf scattered back to each image's pixels
    (`pixlinks`: point -> flat pixel), one MAGMA PNG an image
    (`{i:04d}.png`), and image `trace_idx`'s also as
    `trace_dir/{step}_{suffix}.png`."""
    os.makedirs(out_dir, exist_ok=True)
    H, W = img_res
    flat = np.zeros(n_images * H * W, np.float32)
    flat[np.asarray(pixlinks)] = np.asarray(pdf)
    for i, m in enumerate(flat.reshape(n_images, H, W)):
        colored = apply_colormap(_u8(m))
        write_png(os.path.join(out_dir, f"{i:04d}.png"), colored)
        if trace_idx == i and trace_dir and step is not None:
            write_png(os.path.join(trace_dir, f"{step}_{suffix}.png"),
                      colored)


def write_countmaps(out_dir: str, counts: np.ndarray, pixlinks: np.ndarray,
                    n_images: int, img_res, **kwargs) -> None:
    """The sample counts, over their maximum (at least 1), as hot maps."""
    counts = np.asarray(counts, np.float32)
    counts = counts / max(1.0, float(counts.max()))
    write_hotmaps(out_dir, counts, pixlinks, n_images, img_res,
                  suffix="cnt", **kwargs)


_POINTS_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pointcloud</title></head>
<body style="margin:0;background:#111">
<canvas id="c" width="1000" height="800" style="display:block;margin:auto"></canvas>
<script>
const pts = %%POINTS%%;
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
let ax = 0.5, ay = 0.5, dist = 3.0, drag = false, lx = 0, ly = 0;
canvas.onmousedown = e => { drag = true; lx = e.clientX; ly = e.clientY; };
window.onmouseup = () => drag = false;
window.onmousemove = e => { if (!drag) return;
  ay += (e.clientX - lx) * 0.01; ax += (e.clientY - ly) * 0.01;
  lx = e.clientX; ly = e.clientY; draw(); };
canvas.onwheel = e => { dist *= e.deltaY > 0 ? 1.1 : 0.9; draw();
  e.preventDefault(); };
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  const ca = Math.cos(ax), sa = Math.sin(ax);
  const cb = Math.cos(ay), sb = Math.sin(ay);
  const f = 400 / dist;
  ctx.fillStyle = '#7fd4ff';
  for (let i = 0; i < pts.length; i += 3) {
    let x = pts[i], y = pts[i+1], z = pts[i+2];
    let x1 = cb*x + sb*z, z1 = -sb*x + cb*z;
    let y1 = ca*y - sa*z1, z2 = sa*y + ca*z1 + dist;
    if (z2 < 0.1) continue;
    ctx.fillRect(500 + f*x1/z2*3, 400 - f*y1/z2*3, 1.2, 1.2);
  }
}
draw();
</script></body></html>
"""


def write_pointcloud_html(points: np.ndarray, path: str,
                          max_points: int = 200_000) -> None:
    """A self-contained interactive point-cloud viewer, at most
    `max_points` points (a seeded subset, as the JAX writer takes)."""
    pts = np.asarray(points, np.float32)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[idx]
    data = json.dumps(np.round(pts, 3).reshape(-1).tolist())
    with open(path, "w") as f:
        f.write(_POINTS_HTML_TEMPLATE.replace("%%POINTS%%", data))


_MESH_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mesh</title></head>
<body style="margin:0;background:#111;color:#ddd;font:12px monospace">
<canvas id="c" width="1100" height="850" style="display:block;margin:auto"></canvas>
<div style="text-align:center">drag: rotate &middot; wheel: zoom &middot; %%NTRIS%% faces, %%NCAMS%% cameras</div>
<script>
const V = %%VERTS%%;          // flat xyz
const F = %%FACES%%;          // flat vertex indices
const CAMS = %%CAMS%%;        // per camera: 15 floats (apex + 4 corners)
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
let ax = 0.4, ay = 0.7, dist = 6.0, drag = false, lx = 0, ly = 0;
canvas.onmousedown = e => { drag = true; lx = e.clientX; ly = e.clientY; };
window.onmouseup = () => drag = false;
window.onmousemove = e => { if (!drag) return;
  ay += (e.clientX - lx) * 0.01; ax += (e.clientY - ly) * 0.01;
  lx = e.clientX; ly = e.clientY; draw(); };
canvas.onwheel = e => { dist *= e.deltaY > 0 ? 1.1 : 0.9; draw();
  e.preventDefault(); };
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  const ca = Math.cos(ax), sa = Math.sin(ax);
  const cb = Math.cos(ay), sb = Math.sin(ay);
  const f = 420 / dist, cx = 550, cy = 425;
  function proj(x, y, z) {   // rotate, translate, perspective
    const x1 = cb*x + sb*z, z1 = -sb*x + cb*z;
    const y1 = ca*y - sa*z1, z2 = sa*y + ca*z1 + dist;
    return [cx + f*x1/Math.max(z2,0.1)*3, cy - f*y1/Math.max(z2,0.1)*3, z2];
  }
  // project vertices once
  const P = new Float32Array(V.length);
  for (let i = 0; i < V.length; i += 3) {
    const p = proj(V[i], V[i+1], V[i+2]);
    P[i] = p[0]; P[i+1] = p[1]; P[i+2] = p[2];
  }
  // painter's algorithm over faces
  const order = [];
  for (let t = 0; t < F.length; t += 3) {
    const z = (P[3*F[t]+2] + P[3*F[t+1]+2] + P[3*F[t+2]+2]) / 3;
    if (z > 0.1) order.push([z, t]);
  }
  order.sort((a, b) => b[0] - a[0]);
  for (const [z, t] of order) {
    const a = 3*F[t], b = 3*F[t+1], c = 3*F[t+2];
    // world-space flat shading from the face normal
    const ux = V[b]-V[a], uy = V[b+1]-V[a+1], uz = V[b+2]-V[a+2];
    const vx = V[c]-V[a], vy = V[c+1]-V[a+1], vz = V[c+2]-V[a+2];
    let nx = uy*vz-uz*vy, ny = uz*vx-ux*vz, nz = ux*vy-uy*vx;
    const nl = Math.hypot(nx, ny, nz) || 1;
    const sh = 0.35 + 0.65 * Math.abs((nx*0.5 + ny*0.7 + nz*0.3) / nl);
    ctx.fillStyle = `rgb(${40+140*sh|0},${60+150*sh|0},${90+160*sh|0})`;
    ctx.beginPath();
    ctx.moveTo(P[a], P[a+1]); ctx.lineTo(P[b], P[b+1]);
    ctx.lineTo(P[c], P[c+1]); ctx.closePath(); ctx.fill();
  }
  // camera frusta: apex + 4 image-plane corners
  ctx.strokeStyle = '#ffb84d'; ctx.lineWidth = 1.2;
  for (let i = 0; i < CAMS.length; i += 15) {
    const pts = [];
    for (let k = 0; k < 5; k++)
      pts.push(proj(CAMS[i+3*k], CAMS[i+3*k+1], CAMS[i+3*k+2]));
    if (pts.some(p => p[2] <= 0.1)) continue;
    ctx.beginPath();
    for (let k = 1; k <= 4; k++) {
      ctx.moveTo(pts[0][0], pts[0][1]); ctx.lineTo(pts[k][0], pts[k][1]);
      const n = k === 4 ? 1 : k + 1;
      ctx.moveTo(pts[k][0], pts[k][1]); ctx.lineTo(pts[n][0], pts[n][1]);
    }
    ctx.stroke();
  }
}
draw();
</script></body></html>
"""


def write_mesh_html(verts: np.ndarray, tris: np.ndarray, path: str,
                    poses: np.ndarray | None = None,
                    intrinsics: np.ndarray | None = None,
                    max_tris: int = 60_000, frustum_scale: float = 0.25
                    ) -> None:
    """Self-contained interactive mesh + camera-frustum viewer.

    Parity with the reference's per-val-epoch plotly surface trace +
    camera quiver HTML (`utils/plots.py:15-73,188-225`),
    dependency-free. `poses`: (N, 4, 4) c2w OpenCV-convention;
    `intrinsics`: (N, 4, 4) or (N, 3, 3) used for frustum aspect.
    """
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    if len(tris) > max_tris:
        idx = np.random.default_rng(0).choice(len(tris), max_tris,
                                              replace=False)
        tris = tris[idx]
    used = np.unique(tris.reshape(-1))
    remap = np.full(verts.shape[0] if len(verts) else 1, -1, np.int64)
    remap[used] = np.arange(len(used))
    verts_u = verts[used] if len(used) else np.zeros((0, 3), np.float32)
    tris_u = remap[tris.reshape(-1)].reshape(-1, 3)

    cams = []
    if poses is not None:
        poses = np.asarray(poses, np.float32)
        for i, pose in enumerate(poses):
            apex = pose[:3, 3]
            R = pose[:3, :3]
            if intrinsics is not None:
                K = np.asarray(intrinsics[i])
                hw = float(K[0, 2]) / float(K[0, 0])
                hh = float(K[1, 2]) / float(K[1, 1])
            else:
                hw = hh = 0.5
            s = frustum_scale
            corners = np.array([
                [-hw, -hh, 1.0], [hw, -hh, 1.0],
                [hw, hh, 1.0], [-hw, hh, 1.0]], np.float32) * s
            world = corners @ R.T + apex
            cams.append(np.concatenate([apex[None], world], 0).reshape(-1))
    cams_flat = (np.concatenate(cams).round(3).tolist() if cams else [])

    html = (_MESH_HTML_TEMPLATE
            .replace("%%VERTS%%",
                     json.dumps(verts_u.round(3).reshape(-1).tolist()))
            .replace("%%FACES%%",
                     json.dumps(tris_u.reshape(-1).tolist()))
            .replace("%%CAMS%%", json.dumps(cams_flat))
            .replace("%%NTRIS%%", str(len(tris_u)))
            .replace("%%NCAMS%%", str(len(cams))))
    with open(path, "w") as f:
        f.write(html)
