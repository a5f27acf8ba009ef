// The SDF net's four-stream tangent form on `wgmma_layer.cuh`, shared by
// K3 (`render_core.cu`: the radiance net, and the light head, after it)
// and K10 (`sdf_outputs.cu`: the SDF net alone, clamped to the bounding
// sphere).
//
// A block of kPoints points carries four streams a point, the
// activations and the three spatial tangents, as 128 rows in two m64
// tiles: the primal at row 16 w + g and t_x at row 16 w + g + 8 of tile
// 0, t_y and t_z at the same rows of tile 1 (point 8 w + g,
// `stream_row`), so a thread's wgmma accumulators hold all four streams
// of one (point, column). Two consumer warpgroups each take half of a
// hidden layer's columns over all 128 rows (2 x 64 accumulators a
// thread), meet at a named barrier once both have retired, and write the
// layer in place over its input (`tangent_hidden`): softplus100(z) and
// softplus100'(z) (t W) in registers, nothing stashed for a reverse
// sweep. The encoding and its analytic tangents are computed once into
// an f32 cache (`wg::pe_cache`) and written from it at layer 0 and,
// scaled by 1/sqrt(2), at the skip (`pe_streams`).
#pragma once

#include "wgmma_layer.cuh"

namespace i2sdf {
namespace {

using namespace wg;

constexpr int kPoints = 32;  // points a block

// Row of stream s (0 the activations, 1-3 d/dx_k) of point p in its tile
// (tile 0 for s < 2, tile 1 otherwise).
__device__ __forceinline__ int stream_row(int s, int p) {
  return 16 * (p >> 3) + (p & 7) + 8 * (s & 1);
}

// The block's cached encodings: PE(x) (`px`), its tangents d/dx_k (`tx`,
// three blocks of kPoints rows) and PE(dirs) (`pd`, K3's), kPeStride
// floats a row, with their widths 3 + 6F.
struct Enc {
  const float *px, *tx, *pd;
  int dx, dd;
};

// scale * PE(x) into columns [col0, kend) of the activation rows and
// scale * d PE / d x_k into those of tangent k's rows, zero past the
// encoding's columns: two threads a row of the 128.
__device__ __forceinline__ void pe_streams(unsigned char* t0,
                                           unsigned char* t1, const Enc& e,
                                           int col0, int kend, float scale) {
  const int sr = threadIdx.x >> 1, s = sr >> 5, p = sr & (kPoints - 1);
  const float* src =
      (s == 0 ? e.px : e.tx + (s - 1) * kPoints * kPeStride) + p * kPeStride;
  unsigned char* tile = s < 2 ? t0 : t1;
  for (int q = threadIdx.x & 1; q < kend - col0; q += 2)
    put1(tile, stream_row(s, p), col0 + q, q < e.dx ? src[q] * scale : 0.f);
}

// A hidden SDF layer, this warpgroup's NW columns from col0 over the four
// streams (accumulators a0: tile 0, a1: tile 1): h' = bf16(scale *
// softplus100(z)), t_k' = bf16(scale * softplus100'(z) * (t_k W)); then,
// after a barrier, the skip's encoding where the next layer takes it.
template <int NW>
__device__ __forceinline__ void tangent_hidden(
    float* a0, float* a1, unsigned char* t0, unsigned char* t1, const int* L,
    const int* next, const float* __restrict__ b, const Enc& enc, int col0,
    bool active, Ring& ring) {
  products<NW, 2>(a0, a1, smem_addr(t0), smem_addr(t1), col0, L[kK], ring);
  bar_sync(1, kConsumers);  // both halves retired: the tiles may change
  if (active) {
    const Frag f;
    const float scale = (L[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const int r = f.row();
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
      const float* p0 = a0 + 4 * j;  // primal, t_x
      const float* p1 = a1 + 4 * j;  // t_y, t_z
      float h0, h1, s0, s1;
      softplus_pair(p0[0] + bb.x, h0, s0);
      softplus_pair(p0[1] + bb.y, h1, s1);
      s0 *= scale;
      s1 *= scale;
      put_pair(t0, r, col, h0 * scale, h1 * scale);
      put_pair(t0, r + 8, col, s0 * p0[2], s1 * p0[3]);
      put_pair(t1, r, col, s0 * p1[0], s1 * p1[1]);
      put_pair(t1, r + 8, col, s0 * p1[2], s1 * p1[3]);
    }
  }
  if (next[kFlags] & kSkipIn) {
    bar_sync(1, kConsumers);
    pe_streams(t0, t1, enc, next[kCol], next[kK], kInvSqrt2);
  }
  fence_async();
  bar_sync(1, kConsumers);
}

}  // namespace
}  // namespace i2sdf
