// Dense TSDF fusion of depth maps (host-side).
//
// Replaces open3d ScalableTSDFVolume.integrate used by the reference's
// mesh-score `refuse` step (utils/mesh_util.py:93-115):
// render depth from every training pose, fuse into a TSDF volume, and
// extract the fused surface. Extraction reuses i2sdf_marching_tetrahedra.

#include "common.h"

#include <cmath>

extern "C" {

// Integrate one depth map into the TSDF volume.
// tsdf/weights: dense grids (nx*ny*nz), index (i*ny + j)*nz + k at world
//   point origin + voxel_size * (i, j, k).
// depth: (h, w) z-depth; K: 3x3 row-major intrinsics; w2c: 4x4 row-major
//   world-to-camera. trunc: truncation distance.
int i2sdf_tsdf_integrate(float* tsdf, float* weight, int nx, int ny, int nz,
                         float ox, float oy, float oz, float voxel_size,
                         const float* depth, int h, int w, const float* K,
                         const float* w2c, float trunc, float depth_max) {
  const float fx = K[0], sk = K[1], cx = K[2];
  const float fy = K[4], cy = K[5];
  for (int i = 0; i < nx; ++i) {
    for (int j = 0; j < ny; ++j) {
      for (int k = 0; k < nz; ++k) {
        const float X = ox + voxel_size * i;
        const float Y = oy + voxel_size * j;
        const float Z = oz + voxel_size * k;
        // world -> camera
        const float xc = w2c[0] * X + w2c[1] * Y + w2c[2] * Z + w2c[3];
        const float yc = w2c[4] * X + w2c[5] * Y + w2c[6] * Z + w2c[7];
        const float zc = w2c[8] * X + w2c[9] * Y + w2c[10] * Z + w2c[11];
        if (zc <= 1e-6f) continue;
        const float u = (fx * xc + sk * yc) / zc + cx;
        const float v = fy * yc / zc + cy;
        const int ui = static_cast<int>(std::lround(u));
        const int vi = static_cast<int>(std::lround(v));
        if (ui < 0 || ui >= w || vi < 0 || vi >= h) continue;
        const float d = depth[vi * w + ui];
        if (d <= 1e-6f || d > depth_max) continue;
        const float sdf = d - zc;  // positive in front of the surface
        if (sdf < -trunc) continue;
        const float t = std::min(sdf, trunc) / trunc;
        const int64_t id = (static_cast<int64_t>(i) * ny + j) * nz + k;
        const float wgt = weight[id];
        tsdf[id] = (tsdf[id] * wgt + t) / (wgt + 1.0f);
        weight[id] = wgt + 1.0f;
      }
    }
  }
  return 0;
}

// Mark unobserved voxels (weight == 0) with a fill value so marching
// tetrahedra does not hallucinate surfaces there.
void i2sdf_tsdf_mask_unobserved(float* tsdf, const float* weight,
                                int64_t n, float fill) {
  for (int64_t i = 0; i < n; ++i)
    if (weight[i] == 0.0f) tsdf[i] = fill;
}

}  // extern "C"
