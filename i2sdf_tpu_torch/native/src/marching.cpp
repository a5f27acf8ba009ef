// Isosurface extraction: marching tetrahedra over a dense scalar grid.
//
// Replaces skimage.measure.marching_cubes used by the reference at
// utils/plots.py:201 and model/eval/recon.py:53,96.
// Clean-room: each cell is split into 6 tetrahedra; per-tet surface
// crossings are derived from the 4 corner signs (no lookup tables to
// transcribe). Shared vertices are deduplicated on grid-edge keys so the
// mesh is watertight across cells.

#include "common.h"

#include <cmath>
#include <unordered_map>

namespace {

struct V3 {
  double x, y, z;
};

// The 6-tetrahedra decomposition of a cube (corner indices 0..7 with
// corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))). All six share
// the main diagonal 0-7, which guarantees face-consistent splits between
// neighboring cubes.
constexpr int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

struct EdgeKey {
  int64_t a, b;
  bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};

struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    return std::hash<int64_t>()(k.a * 1000003 ^ k.b);
  }
};

}  // namespace

extern "C" {

void i2sdf_free(void* p) { std::free(p); }

// grid: nx*ny*nz scalars, index (i*ny + j)*nz + k at point
//   origin + (i*sx, j*sy, k*sz).
// Emits vertices (nv x 3 float, world units) and triangles (nt x 3 int),
// oriented so normals point toward positive field values (outside, for
// an SDF with level 0).
int i2sdf_marching_tetrahedra(const float* grid, int nx, int ny, int nz,
                              float level, float ox, float oy, float oz,
                              float sx, float sy, float sz,
                              float** out_verts, int32_t** out_tris,
                              int32_t* out_nv, int32_t* out_nt) {
  std::vector<float> verts;
  std::vector<int32_t> tris;
  std::unordered_map<EdgeKey, int32_t, EdgeKeyHash> edge_cache;
  edge_cache.reserve(1 << 16);

  auto gid = [&](int i, int j, int k) -> int64_t {
    return (static_cast<int64_t>(i) * ny + j) * nz + k;
  };
  auto value = [&](int64_t id) -> double {
    return static_cast<double>(grid[id]) - level;
  };
  auto point = [&](int64_t id) -> V3 {
    int k = static_cast<int>(id % nz);
    int j = static_cast<int>((id / nz) % ny);
    int i = static_cast<int>(id / (static_cast<int64_t>(ny) * nz));
    return {ox + i * sx, oy + j * sy, oz + k * sz};
  };

  // interpolated vertex on grid edge (a, b); cached for watertightness
  auto edge_vertex = [&](int64_t a, int64_t b) -> int32_t {
    if (a > b) std::swap(a, b);
    EdgeKey key{a, b};
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    double va = value(a), vb = value(b);
    double t = va / (va - vb);
    if (!(t >= 0.0)) t = 0.0;
    if (!(t <= 1.0)) t = 1.0;
    V3 pa = point(a), pb = point(b);
    int32_t idx = static_cast<int32_t>(verts.size() / 3);
    verts.push_back(static_cast<float>(pa.x + t * (pb.x - pa.x)));
    verts.push_back(static_cast<float>(pa.y + t * (pb.y - pa.y)));
    verts.push_back(static_cast<float>(pa.z + t * (pb.z - pa.z)));
    edge_cache.emplace(key, idx);
    return idx;
  };

  // orient so triangle normals align with the field gradient (toward
  // positive/outside); the field is linear inside a tet so the gradient
  // is exact: solve g . (pi - p0) = vi - v0 (Cramer's rule)
  auto emit = [&](int32_t v0, int32_t v1, int32_t v2, const int64_t n[4]) {
    if (v0 == v1 || v1 == v2 || v0 == v2) return;
    V3 p0 = point(n[0]);
    double a[3][3], d[3];
    for (int r = 0; r < 3; ++r) {
      V3 pr = point(n[r + 1]);
      a[r][0] = pr.x - p0.x;
      a[r][1] = pr.y - p0.y;
      a[r][2] = pr.z - p0.z;
      d[r] = value(n[r + 1]) - value(n[0]);
    }
    auto det3 = [](const double m[3][3]) {
      return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
             m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
             m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
    };
    double det = det3(a);
    double g[3] = {0, 0, 0};
    if (std::fabs(det) > 1e-30) {
      for (int c = 0; c < 3; ++c) {
        double m[3][3];
        std::memcpy(m, a, sizeof(m));
        for (int r = 0; r < 3; ++r) m[r][c] = d[r];
        g[c] = det3(m) / det;
      }
    }
    const float* a0 = &verts[3 * v0];
    const float* a1 = &verts[3 * v1];
    const float* a2 = &verts[3 * v2];
    double e1[3] = {a1[0] - a0[0], a1[1] - a0[1], a1[2] - a0[2]};
    double e2[3] = {a2[0] - a0[0], a2[1] - a0[1], a2[2] - a0[2]};
    double nrm[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                     e1[2] * e2[0] - e1[0] * e2[2],
                     e1[0] * e2[1] - e1[1] * e2[0]};
    if (nrm[0] * g[0] + nrm[1] * g[1] + nrm[2] * g[2] < 0.0)
      std::swap(v1, v2);
    tris.push_back(v0);
    tris.push_back(v1);
    tris.push_back(v2);
  };

  for (int i = 0; i + 1 < nx; ++i) {
    for (int j = 0; j + 1 < ny; ++j) {
      for (int k = 0; k + 1 < nz; ++k) {
        int64_t corner[8];
        for (int c = 0; c < 8; ++c)
          corner[c] = gid(i + (c & 1), j + ((c >> 1) & 1), k + ((c >> 2) & 1));

        for (const auto& tet : kTets) {
          int64_t n[4] = {corner[tet[0]], corner[tet[1]], corner[tet[2]],
                          corner[tet[3]]};
          int inside = 0;  // value < 0 (interior of the SDF)
          bool in[4], valid = true;
          for (int c = 0; c < 4; ++c) {
            double vc = value(n[c]);
            valid &= std::isfinite(vc);
            in[c] = vc < 0.0;
            inside += in[c];
          }
          // NaN corners mark unobserved voxels (TSDF fusion) — no surface
          if (!valid || inside == 0 || inside == 4) continue;

          // canonical ordering: negatives first
          int neg[4], pos[4], nn = 0, np = 0;
          for (int c = 0; c < 4; ++c) (in[c] ? neg[nn++] : pos[np++]) = c;

          if (inside == 1 || inside == 3) {
            // one triangle separating the lone corner
            int lone = (inside == 1) ? neg[0] : pos[0];
            int others[3];
            int w = 0;
            for (int c = 0; c < 4; ++c)
              if (c != lone) others[w++] = c;
            int32_t v0 = edge_vertex(n[lone], n[others[0]]);
            int32_t v1 = edge_vertex(n[lone], n[others[1]]);
            int32_t v2 = edge_vertex(n[lone], n[others[2]]);
            emit(v0, v1, v2, n);
          } else {
            // 2-2 split: quad between the two pairs -> two triangles
            int32_t q0 = edge_vertex(n[neg[0]], n[pos[0]]);
            int32_t q1 = edge_vertex(n[neg[0]], n[pos[1]]);
            int32_t q2 = edge_vertex(n[neg[1]], n[pos[1]]);
            int32_t q3 = edge_vertex(n[neg[1]], n[pos[0]]);
            emit(q0, q1, q2, n);
            emit(q0, q2, q3, n);
          }
        }
      }
    }
  }

  *out_nv = static_cast<int32_t>(verts.size() / 3);
  *out_nt = static_cast<int32_t>(tris.size() / 3);
  *out_verts = copy_out(verts);
  *out_tris = copy_out(tris);
  return 0;
}

}  // extern "C"
