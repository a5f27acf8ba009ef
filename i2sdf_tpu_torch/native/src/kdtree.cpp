// 3-D KD-tree nearest-neighbor queries for Chamfer / F-score mesh
// evaluation. Replaces sklearn.neighbors.KDTree used by the reference at
// utils/mesh_util.py:4,18.

#include "common.h"

#include <algorithm>
#include <array>
#include <cmath>
#include <limits>

namespace {

struct Node {
  float pt[3];
  int axis;
  int32_t left = -1, right = -1;
};

struct KDTree {
  std::vector<Node> nodes;
  int32_t root = -1;

  int32_t build(std::vector<std::array<float, 3>>& pts, int lo, int hi,
                int depth) {
    if (lo >= hi) return -1;
    int axis = depth % 3;
    int mid = (lo + hi) / 2;
    std::nth_element(pts.begin() + lo, pts.begin() + mid, pts.begin() + hi,
                     [axis](const auto& a, const auto& b) {
                       return a[axis] < b[axis];
                     });
    int32_t id = static_cast<int32_t>(nodes.size());
    nodes.push_back({});
    Node& stub = nodes.back();
    stub.pt[0] = pts[mid][0];
    stub.pt[1] = pts[mid][1];
    stub.pt[2] = pts[mid][2];
    stub.axis = axis;
    int32_t l = build(pts, lo, mid, depth + 1);
    int32_t r = build(pts, mid + 1, hi, depth + 1);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  void nearest(const float* q, int32_t id, float& best) const {
    if (id < 0) return;
    const Node& n = nodes[id];
    float dx = q[0] - n.pt[0], dy = q[1] - n.pt[1], dz = q[2] - n.pt[2];
    float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < best) best = d2;
    float delta = q[n.axis] - n.pt[n.axis];
    int32_t near = delta < 0 ? n.left : n.right;
    int32_t far = delta < 0 ? n.right : n.left;
    nearest(q, near, best);
    if (delta * delta < best) nearest(q, far, best);
  }
};

}  // namespace

extern "C" {

// For each query point, the euclidean distance to its nearest reference
// point. ref: (n_ref, 3); query: (n_q, 3); out: (n_q,).
int i2sdf_nn_distances(const float* ref, int32_t n_ref, const float* query,
                       int32_t n_q, float* out) {
  if (n_ref <= 0) return -1;
  std::vector<std::array<float, 3>> pts(n_ref);
  for (int32_t i = 0; i < n_ref; ++i)
    pts[i] = {ref[3 * i], ref[3 * i + 1], ref[3 * i + 2]};
  KDTree tree;
  tree.nodes.reserve(n_ref);
  tree.root = tree.build(pts, 0, n_ref, 0);
  for (int32_t i = 0; i < n_q; ++i) {
    float best = std::numeric_limits<float>::max();
    tree.nearest(query + 3 * i, tree.root, best);
    out[i] = std::sqrt(best);
  }
  return 0;
}

}  // extern "C"
