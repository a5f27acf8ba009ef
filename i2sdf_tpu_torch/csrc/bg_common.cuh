// Device code shared by K8 (`bg_core.cu`) and K9 (`bg_core_bwd.cu`), the
// NeRF++ background's pair of MLPs: the implicit net on PE(x4), its last
// layer's columns in the kernels' order [features | sigma], and the
// radiance net on [features | PE(view)] (its first layer's rows permuted
// to match; the nets' own order is [PE(view), features]).
#pragma once

#include "common.cuh"

namespace i2sdf {

// Column p of the wide-block positional encoding of a d-coordinate point
// x: [x | sin(x_i 2^j) dim-major | cos(x_i 2^j) dim-major], d (1 + 2F)
// wide; with F = 0 the raw coordinates.
__device__ __forceinline__ float pe_value_d(const float* x, int d, int F,
                                            int p) {
  if (p < d) return x[p];
  int q = p - d;
  const bool is_cos = q >= d * F;
  if (is_cos) q -= d * F;
  const float arg = x[q / F] * ldexpf(1.f, q % F);
  return is_cos ? cosf(arg) : sinf(arg);
}

// Write scale * PE(points) (d floats a row) into columns [col0, kend) of a
// bf16 row buffer, zero beyond the encoding's width.
__device__ __forceinline__ void write_pe_d(__nv_bfloat16* buf, int lda,
                                           int rows, const float* pts, int d,
                                           int F, int col0, int kend,
                                           float scale) {
  const int width = kend - col0, d0 = d * (1 + 2 * F);
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, p = i % width;
    const float v = p < d0 ? pe_value_d(pts + d * r, d, F, p) * scale : 0.f;
    buf[r * lda + col0 + p] = __float2bfloat16_rn(v);
  }
}

// Copy `rows` rows of `d` floats from device memory (rows below n, zero
// beyond) into shared memory.
__device__ __forceinline__ void load_points(float* dst, const float* src,
                                            int d, int rows, int row0,
                                            int n) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = row0 + i / d;
    dst[i] = r < n ? src[(size_t)r * d + i % d] : 0.f;
  }
}

}  // namespace i2sdf
