// K11's device code: the SDF net swept forward with its three spatial
// tangents on mma.sync (sm_90a, plain C interface).
//
// Forward mode through a layer y = act(h W + b): z = h W + b, y =
// softplus100(z) and, for the tangent t_k = d h / d x_k,
// t_k' = softplus100'(z) (t_k W). A block holds kTanPoints points and
// stacks the four streams (the activations and the three tangents) as
// four 16-row tiles of one 64-row buffer in shared memory, so each weight
// fragment a warp fetches from L2 feeds four mma instructions, one a
// stream, and a thread holds the four streams of one (point, column) in
// its accumulators: the epilogue scales the tangents by softplus'(z) of
// the primal value beside them, in registers. The encoding's tangents are
// analytic in the block layout [x | sin(x f) | cos(x f)]: d/dx_k is
// [e_k | f cos(x_k f) | -f sin(x_k f)] in axis k's blocks, zero in the
// others; with no encoding (frequency count 0) it is e_k.
#pragma once

#include "common.cuh"

namespace i2sdf {

constexpr int kTanPoints = 16;  // points a block
constexpr int kStreams = 4;     // the activations and the three tangents
constexpr int kTanRows = kStreams * kTanPoints;
constexpr int kTanMaxNT = 5;    // up to 8 warps * 5 tiles * 8 = 320 cols

// d PE(x)_p / d x_k (p below the encoding's 3 + 6F columns).
__device__ __forceinline__ float pe_tangent(const float* x, int F, int p,
                                            int k) {
  if (p < 3) return p == k ? 1.f : 0.f;
  int q = p - 3;
  const bool is_cos = q >= 3 * F;
  if (is_cos) q -= 3 * F;
  if (q / F != k) return 0.f;
  const float f = ldexpf(1.f, q % F);
  const float arg = x[k] * f;
  return is_cos ? -f * sinf(arg) : f * cosf(arg);
}

// Write scale * PE(points) into columns [col0, kend) of the activation
// rows and scale * d PE / d x_k into those of tangent k's rows, zero
// beyond the encoding's 3 + 6F columns.
__device__ __forceinline__ void write_pe4(__nv_bfloat16* buf, int lda,
                                          const float* pts, int F, int col0,
                                          int kend, float scale) {
  const int width = kend - col0, d0 = 3 + 6 * F;
  for (int i = threadIdx.x; i < kTanRows * width; i += kThreads) {
    const int r = i / width, p = i % width;
    const int s = r / kTanPoints;
    const float* x = pts + 3 * (r % kTanPoints);
    float v = 0.f;
    if (p < d0) v = (s == 0 ? pe_value(x, F, p) : pe_tangent(x, F, p, s - 1));
    buf[r * lda + col0 + p] = __float2bfloat16_rn(v * scale);
  }
}

// out[64, N] = A[64, K] @ W[K, N] over the block's four stream tiles
// (rows 16 s .. 16 s + 15 are stream s), then
// epi(point, col, v) for every pair of columns, v[s][0..1] the four
// streams' sums at that point and those two columns. A is bf16 in shared
// memory with leading dimension lda; W the packed fragment stream, as in
// `mma_layer`.
template <class Epi>
__device__ __forceinline__ void tangent_layer(const __nv_bfloat16* A, int lda,
                                              int K,
                                              const uint2* __restrict__ W,
                                              int N, Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int NT = N >> 3, KS = K >> 4;
  float acc[kStreams][kTanMaxNT][4];
#pragma unroll
  for (int m = 0; m < kStreams; ++m)
#pragma unroll
    for (int j = 0; j < kTanMaxNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[kStreams][4];
#pragma unroll
    for (int m = 0; m < kStreams; ++m) {
      const __nv_bfloat16* p = A + (m * 16 + g) * lda + kk * 16 + tig * 2;
      a[m][0] = *reinterpret_cast<const uint32_t*>(p);
      a[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
      a[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
    }
#pragma unroll
    for (int j = 0; j < kTanMaxNT; ++j) {
      const int t = warp + kWarps * j;
      if (t < NT) {
        const uint2 b = __ldg(W + ((size_t)t * KS + kk) * 32 + lane);
#pragma unroll
        for (int m = 0; m < kStreams; ++m) mma_bf16(acc[m][j], a[m], b.x, b.y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTanMaxNT; ++j) {
    const int t = warp + kWarps * j;
    if (t < NT) {
      const int col = t * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[kStreams][2];
#pragma unroll
        for (int m = 0; m < kStreams; ++m) {
          v[m][0] = acc[m][j][2 * h];
          v[m][1] = acc[m][j][2 * h + 1];
        }
        epi(g + 8 * h, col, v);
      }
    }
  }
}

// Hidden layer of the tangent sweep: h' = bf16(scale * softplus100(z)),
// t_k' = bf16(scale * softplus100'(z) * (t_k W)).
struct EpiTangent {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  float scale;
  __device__ __forceinline__ void operator()(int p, int c,
                                             const float (&v)[kStreams][2]) {
    const float z0 = v[0][0] + bias[c], z1 = v[0][1] + bias[c + 1];
    const float s0 = dsoftplus100(z0) * scale, s1 = dsoftplus100(z1) * scale;
    put2(out + p * lda + c, softplus100(z0) * scale,
         softplus100(z1) * scale);
#pragma unroll
    for (int k = 1; k < kStreams; ++k)
      put2(out + (k * kTanPoints + p) * lda + c, s0 * v[k][0], s1 * v[k][1]);
  }
};

// The output layer's activation rows: columns [0, out_cols) of points
// below n to device memory, the net's own order [sdf | features]; the sdf
// to shared memory, where the epilogue's clamp reads it.
struct EpiTanOut {
  float* out;
  const float* bias;
  int row0, n, out_cols;
  float* sdf_s;
  __device__ __forceinline__ void put(int r, int c, float v) {
    if (c >= out_cols) return;
    v += bias[c];
    if (c == 0)
      sdf_s[r] = v;
    else if (row0 + r < n)
      out[(size_t)(row0 + r) * out_cols + c] = v;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put(r, c, v0);
    put(r, c + 1, v1);
  }
};

// The output layer's tangent rows, sdf column only: tangent k of point p
// (row 16 k + p of the three tangent tiles) is d sdf / d x_k.
struct EpiTanGrad {
  float* grad_s;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float) {
    if (c == 0) grad_s[(r % kTanPoints) * 3 + r / kTanPoints] = v0;
  }
};

// Shared memory of `tangent_fwd_kernel` (bytes): two activation buffers of
// the four streams, and per point x, the sdf and the gradient (the host
// mirrors it in `sdf_grad.fwd_smem`).
inline size_t tan_fwd_smem_bytes(int lda) {
  return 2 * (size_t)kTanRows * lda * sizeof(__nv_bfloat16) +
         (size_t)kTanPoints * (3 + 1 + 3) * sizeof(float);
}

namespace {

// K11: the tangent sweep through the hidden layers (the encoding and its
// tangents written again, scaled by 1/sqrt(2), at a skip), the output
// layer's columns for the activation rows and its sdf column alone for
// the tangent rows (one warp: the other columns of a tangent are never
// read), then per point the sdf and its gradient, unclamped.
__global__ void __launch_bounds__(kThreads)
tangent_fwd_kernel(const float* __restrict__ x, int n,
                   const uint2* __restrict__ w, const float* __restrict__ b,
                   Plan fwd, int mx, int lda, int out_cols,
                   float* __restrict__ out, float* __restrict__ grad_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* buf[2];
  buf[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  buf[1] = buf[0] + kTanRows * lda;
  float* xs = reinterpret_cast<float*>(buf[1] + kTanRows * lda);
  float* sdf_s = xs + kTanPoints * 3;
  float* grad_s = sdf_s + kTanPoints;
  const int row0 = blockIdx.x * kTanPoints;
  const int nh = fwd.n - 1;

  for (int i = threadIdx.x; i < kTanPoints * 3; i += kThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
  }
  __syncthreads();
  write_pe4(buf[0], lda, xs, mx, 0, fwd.L[0][kK], 1.f);
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < nh; ++l) {
    const int* L = fwd.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe4(buf[cur], lda, xs, mx, L[kCol], L[kK], kInvSqrt2);
      __syncthreads();
    }
    EpiTangent epi{buf[cur ^ 1], lda, b + L[kBOff],
                   (L[kFlags] & kScale) ? kInvSqrt2 : 1.f};
    tangent_layer(buf[cur], lda, L[kK], w + L[kWOff], L[kN], epi);
    __syncthreads();
    cur ^= 1;
  }
  {
    const int* L = fwd.L[nh];
    EpiTanOut eo{out, b + L[kBOff], row0, n, out_cols, sdf_s};
    mma_layer<1, kTanMaxNT>(buf[cur], lda, L[kK], w + L[kWOff], L[kN], eo);
    EpiTanGrad eg{grad_s};
    mma_layer<kStreams - 1, 1>(buf[cur] + kTanPoints * lda, lda, L[kK],
                               w + L[kWOff], 8, eg);
  }
  __syncthreads();
  if (threadIdx.x < kTanPoints && row0 + threadIdx.x < n) {
    const int p = threadIdx.x;
    const size_t r = row0 + p;
    out[r * out_cols] = sdf_s[p];
    for (int d = 0; d < 3; ++d) grad_out[r * 3 + d] = grad_s[3 * p + d];
  }
}

// Launch `tangent_fwd_kernel` on n points (the arguments as the
// kernel's); returns the launch's error.
inline cudaError_t launch_tangent_fwd(const float* x, int n, const uint2* w,
                                      const float* b, const Plan& fwd, int mx,
                                      int lda, int out_cols, float* out,
                                      float* grad_out, void* stream) {
  const size_t smem = tan_fwd_smem_bytes(lda);
  cudaError_t err = cudaFuncSetAttribute(
      tangent_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kTanPoints - 1) / kTanPoints;
  tangent_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, n, w, b, fwd, mx, lda, out_cols, out, grad_out);
  return cudaGetLastError();
}

}  // namespace

}  // namespace i2sdf
