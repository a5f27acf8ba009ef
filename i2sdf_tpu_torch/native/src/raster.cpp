// Software depth rasterizer: triangle mesh -> per-pixel z-depth.
//
// Replaces pyrender's EGL offscreen depth renders used by the
// reference's TSDF `refuse` (utils/mesh_util.py:55-87).
// No OpenGL is assumed; a simple z-buffered scanline rasterizer on the
// host is exact and fast enough for the per-pose depth passes.

#include "common.h"

#include <algorithm>
#include <cmath>
#include <limits>

extern "C" {

// verts: (nv, 3) world; tris: (nt, 3); K: 3x3 row-major; w2c: 4x4
// row-major world-to-camera (OpenCV convention, +z forward).
// out_depth: (h, w) z-depth, 0 where nothing is hit.
int i2sdf_rasterize_depth(const float* verts, int32_t nv, const int32_t* tris,
                          int32_t nt, const float* K, const float* w2c,
                          int h, int w, float* out_depth) {
  const float fx = K[0], sk = K[1], cx = K[2];
  const float fy = K[4], cy = K[5];
  std::fill(out_depth, out_depth + static_cast<int64_t>(h) * w, 0.0f);
  std::vector<float> zbuf(static_cast<int64_t>(h) * w,
                          std::numeric_limits<float>::max());

  // pre-transform vertices to camera space + projected pixel coords
  std::vector<float> cam(nv * 3), px(nv * 2);
  for (int32_t i = 0; i < nv; ++i) {
    const float X = verts[3 * i], Y = verts[3 * i + 1], Z = verts[3 * i + 2];
    const float xc = w2c[0] * X + w2c[1] * Y + w2c[2] * Z + w2c[3];
    const float yc = w2c[4] * X + w2c[5] * Y + w2c[6] * Z + w2c[7];
    const float zc = w2c[8] * X + w2c[9] * Y + w2c[10] * Z + w2c[11];
    cam[3 * i] = xc;
    cam[3 * i + 1] = yc;
    cam[3 * i + 2] = zc;
    if (zc > 1e-6f) {
      px[2 * i] = (fx * xc + sk * yc) / zc + cx;
      px[2 * i + 1] = fy * yc / zc + cy;
    }
  }

  for (int32_t t = 0; t < nt; ++t) {
    const int32_t a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
    const float za = cam[3 * a + 2], zb = cam[3 * b + 2], zc_ = cam[3 * c + 2];
    if (za <= 1e-6f || zb <= 1e-6f || zc_ <= 1e-6f) continue;  // clip behind
    const float ax = px[2 * a], ay = px[2 * a + 1];
    const float bx = px[2 * b], by = px[2 * b + 1];
    const float cx_ = px[2 * c], cy_ = px[2 * c + 1];

    int x0 = std::max(0, static_cast<int>(std::floor(
                             std::min(ax, std::min(bx, cx_)))));
    int x1 = std::min(w - 1, static_cast<int>(std::ceil(
                                 std::max(ax, std::max(bx, cx_)))));
    int y0 = std::max(0, static_cast<int>(std::floor(
                             std::min(ay, std::min(by, cy_)))));
    int y1 = std::min(h - 1, static_cast<int>(std::ceil(
                                 std::max(ay, std::max(by, cy_)))));
    if (x0 > x1 || y0 > y1) continue;

    const float den = (by - cy_) * (ax - cx_) + (cx_ - bx) * (ay - cy_);
    if (std::fabs(den) < 1e-12f) continue;
    const float inv_den = 1.0f / den;
    const float iza = 1.0f / za, izb = 1.0f / zb, izc = 1.0f / zc_;

    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        const float pxf = x + 0.0f, pyf = y + 0.0f;
        float l0 = ((by - cy_) * (pxf - cx_) + (cx_ - bx) * (pyf - cy_)) *
                   inv_den;
        float l1 = ((cy_ - ay) * (pxf - cx_) + (ax - cx_) * (pyf - cy_)) *
                   inv_den;
        float l2 = 1.0f - l0 - l1;
        const float eps = -1e-5f;
        if (l0 < eps || l1 < eps || l2 < eps) continue;
        // perspective-correct depth interpolation
        const float iz = l0 * iza + l1 * izb + l2 * izc;
        const float z = 1.0f / iz;
        const int64_t id = static_cast<int64_t>(y) * w + x;
        if (z < zbuf[id]) {
          zbuf[id] = z;
          out_depth[id] = z;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
