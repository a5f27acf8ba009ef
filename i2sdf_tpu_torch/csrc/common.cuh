// Shared device code for the port's kernels (sm_90a, plain C interface):
// the layer plan, bf16 packing, the activations, the encoding, the
// backward sweeps' stash and fixed-order sums. Every MLP kernel but K11
// is built on `wgmma_layer.cuh`; K11 (`tangent_common.cuh`) still runs the
// mma.sync layer below.
//
// `mma_layer`: a block of rows flows through a layer as a tiled product
// on the tensor cores with `mma.sync.m16n8k16` (bf16 operands, f32
// accumulation): the block's 8 warps split the layer's output columns into
// 8-wide tiles, and every warp covers all of the block's rows, so each
// weight fragment it loads feeds MT mma instructions. Weights arrive
// pre-packed in fragment order (one 8-byte load per lane per tile,
// coalesced, served from L2). The epilogue is a functor applied to the
// accumulators in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i2sdf {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 16;
constexpr float kInvSqrt2 = 0.70710678118654752f;

// One layer of a packed MLP, as the host builds it
// (i2sdf_tpu_torch/ops/kernels/mma_pack.py).
// kStageRows: for stage images (wgmma_layer.cuh), the rows of W^T a stage
// holds when fewer than N (the layer comes in passes), else 0.
enum LayerField { kK = 0, kN, kReal, kWOff, kBOff, kFlags, kCol, kStageRows };
enum LayerFlags { kSkipIn = 1, kScale = 2 };

struct Plan {
  int n;
  int L[kMaxLayers][8];
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// torch Softplus(beta=100): linear above 100x > 20, stable log1p form below.
__device__ __forceinline__ float softplus100(float x) {
  const float t = 100.f * x;
  if (t > 20.f) return x;
  return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) * 0.01f;
}

// d softplus100 / dx = sigmoid(100 x) (1 in the linear region).
__device__ __forceinline__ float dsoftplus100(float x) {
  const float t = 100.f * x;
  if (t > 20.f) return 1.f;
  return 1.f / (1.f + expf(-t));
}

// Column p of the wide-block positional encoding of point x (3 coords):
// [x | sin(x_i * 2^j) dim-major | cos(x_i * 2^j) dim-major], 3 + 6F wide.
// sinf/cosf are the accurate versions: arguments reach |x| * 2^(F-1).
__device__ __forceinline__ float pe_value(const float* x, int F, int p) {
  if (p < 3) return x[p];
  int q = p - 3;
  const bool is_cos = q >= 3 * F;
  if (is_cos) q -= 3 * F;
  const float arg = x[q / F] * ldexpf(1.f, q % F);
  return is_cos ? cosf(arg) : sinf(arg);
}

// out[rows, N] = A[rows, K] @ W[K, N] for a block of MT*16 rows, then
// epi(row, col, v(col), v(col+1)) for every accumulator pair. A is bf16 in
// shared memory with leading dimension lda; W is the packed fragment
// stream: for tile t (8 columns) and k-step kk (16 deep), lane l holds
// uint2{b0, b1} at W[(t * KS + kk) * 32 + l]. K % 16 == 0, N % 8 == 0,
// N <= 8 * kWarps * MAXNT.
template <int MT, int MAXNT, class Epi>
__device__ __forceinline__ void mma_layer(const __nv_bfloat16* A, int lda,
                                          int K, const uint2* __restrict__ W,
                                          int N, Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int NT = N >> 3, KS = K >> 4;
  float acc[MT][MAXNT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < MAXNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const __nv_bfloat16* p = A + (m * 16 + g) * lda + kk * 16 + tig * 2;
      a[m][0] = *reinterpret_cast<const uint32_t*>(p);
      a[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
      a[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
    }
#pragma unroll
    for (int j = 0; j < MAXNT; ++j) {
      const int t = warp + kWarps * j;
      if (t < NT) {
        const uint2 b = __ldg(W + ((size_t)t * KS + kk) * 32 + lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], a[m], b.x, b.y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) {
    const int t = warp + kWarps * j;
    if (t < NT) {
      const int col = t * 8 + tig * 2;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        epi(m * 16 + g, col, acc[m][j][0], acc[m][j][1]);
        epi(m * 16 + g + 8, col, acc[m][j][2], acc[m][j][3]);
      }
    }
  }
}

// ---- the backward sweeps' shared pieces -----------------------------------
//
// K4, K5, K6 and K9 run their sweeps on `wgmma_layer.cuh` (sdf_sweep.cuh,
// wgmma_sweep.cuh), with `stash_q` below and the fixed-order sums
// (`sum_kernel`).

constexpr int kMaxSdf = 12;
constexpr int kMaxRad = 8;
constexpr int kMaxLight = 4;
constexpr int kMaxJobs = kMaxSdf + kMaxRad + kMaxLight;
// a row's cotangents [c_grad | c_sdf | c_rgb | c_lm], in device memory
// and in shared memory
constexpr int kCot = 8;

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

// The activation derivative as stored for the backward: q =
// sigmoid(-|100 z|) with the sign bit set where z > 0 (-0 in softplus's
// linear region), so both s = sigmoid(100 z) and 1 - s keep bf16's
// relative precision in the second-order factor 100 s (1 - s).
__device__ __forceinline__ float stash_q(float z) {
  const float t = 100.f * z;
  if (t > 20.f) return -0.f;
  const float q = 1.f / (1.f + expf(fabsf(t)));
  return t > 0.f ? -q : q;
}

// s = softplus100'(z) from the stash.
__device__ __forceinline__ float stash_s(float v) {
  return signbit(v) ? 1.f + v : v;
}

// 100 s (1 - s) from the stash.
__device__ __forceinline__ float stash_d2(float v) {
  const float q = fabsf(v);
  return 100.f * q * (1.f - q);
}

namespace {

// ---- fixed-order sums of the partials -----------------------------------

struct SumJob {
  const float* src;  // (s, e)
  float* dst;        // (e,)
  long long e;
  int s;
};

struct SumJobs {
  SumJob j[kMaxJobs + 1];
  int n;
  long long total;
};

__global__ void __launch_bounds__(kThreads) sum_kernel(SumJobs jobs) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < jobs.total; i += (long long)gridDim.x * kThreads) {
    long long e = i;
    int ji = 0;
    while (ji < jobs.n - 1 && e >= jobs.j[ji].e) {
      e -= jobs.j[ji].e;
      ++ji;
    }
    const SumJob& J = jobs.j[ji];
    float acc = 0.f;
    for (int s = 0; s < J.s; ++s) acc += J.src[(size_t)s * J.e + e];
    J.dst[e] = acc;
  }
}

}  // namespace

inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline Plan read_plan(const int* desc, int n) {
  Plan p;
  p.n = n;
  for (int l = 0; l < n && l < kMaxLayers; ++l)
    for (int f = 0; f < 8; ++f) p.L[l][f] = desc[l * 8 + f];
  return p;
}

}  // namespace i2sdf
