// Device code shared by K8 (`bg_core.cu`) and K9 (`bg_core_bwd.cu`), the
// NeRF++ background's pair of MLPs on `wgmma_layer.cuh`: the implicit net
// on PE(x4), its last layer's columns in the kernels' order [features |
// sigma], and the radiance net on [features | PE(view)] (its first
// layer's rows permuted to match; the nets' own order is [PE(view),
// features]).
#pragma once

#include "wgmma_layer.cuh"

namespace i2sdf {
namespace wg {

// Column p of the wide-block positional encoding of a d-coordinate point
// x: [x | sin(x_i 2^j) dim-major | cos(x_i 2^j) dim-major], d (1 + 2F)
// wide; with F = 0 the raw coordinates. The accurate sinf / cosf, as the
// plain op's.
__device__ __forceinline__ float pe_value_d(const float* x, int d, int F,
                                            int p) {
  if (p < d) return x[p];
  int q = p - d;
  const bool is_cos = q >= d * F;
  if (is_cos) q -= d * F;
  const float arg = x[q / F] * ldexpf(1.f, q % F);
  return is_cos ? cosf(arg) : sinf(arg);
}

// scale * PE(pts) (d floats a row) into columns [col0, kend) of a 64-row
// tile (`act_off`), zero past the encoding's d (1 + 2F) columns: thread t
// of nt.
__device__ __forceinline__ void fill_pe(unsigned char* tile, const float* pts,
                                        int d, int F, int col0, int kend,
                                        float scale, int t, int nt) {
  const int w = kend - col0, d0 = d * (1 + 2 * F);
  for (int i = t; i < 64 * w; i += nt) {
    const int r = i / w, q = i - r * w;
    put1(tile, r, col0 + q,
         q < d0 ? pe_value_d(pts + d * r, d, F, q) * scale : 0.f);
  }
}

// `rows` rows of `d` floats from device memory (rows below n, zero
// beyond) into shared memory: thread t of nt.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int d, int rows, int row0,
                                              int n, int t, int nt) {
  for (int i = t; i < rows * d; i += nt) {
    const int r = row0 + i / d;
    dst[i] = r < n ? src[(size_t)r * d + i % d] : 0.f;
  }
}

}  // namespace wg
}  // namespace i2sdf
