// Shared device code for the port's kernels (sm_90a, plain C interface).
// K1 and K3 are built on `wgmma_layer.cuh` instead; the rest here.
//
// A block of rows flows through a whole MLP with its activations in shared
// memory. Each layer is a tiled product on the tensor cores with
// `mma.sync.m16n8k16` (bf16 operands, f32 accumulation): the block's 8
// warps split the layer's output columns into 8-wide tiles, and every warp
// covers all of the block's rows, so each weight fragment it loads feeds
// MT mma instructions. Weights arrive pre-packed in fragment order (one
// 8-byte load per lane per tile, coalesced, served from L2), so no weight
// ever passes through shared memory. The epilogue (bias, activation,
// derivative stash, skip scaling) is a functor applied to the
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

// ---- the SDF net's mma.sync backward (K12) ---------------------------------
//
// K12 (sdf_grad_bwd.cu) stages every layer's weight-gradient operands in
// device memory (`Scratch`), then runs the split-K products and the
// fixed-order sums (`launch_wgrad`). K4, K5 and K6 run their sweeps on
// `wgmma_layer.cuh` (sdf_sweep.cuh), with `stash_q` below.

constexpr int kMaxSdf = 12;
constexpr int kMaxRad = 8;
constexpr int kMaxLight = 4;
constexpr int kMaxJobs = kMaxSdf + kMaxRad + kMaxLight;
// a row's cotangents [c_grad | c_sdf | c_rgb | c_lm], in device memory
// and in shared memory
constexpr int kCot = 8;

__device__ __forceinline__ float bf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

// Where the backward stages each layer's operands (element pointers into
// the bf16 and f32 scratch), as the host's table lays them out
// (i2sdf_tpu_torch/ops/kernels/render_core.py::_BwdPlan).
struct Scratch {
  __nv_bfloat16* ax[kMaxSdf];   // (streams np, K_l): the layer's inputs
  __nv_bfloat16* br[kMaxSdf];   // (streams np, N_l): their cotangents
  float* dbpart;                // (blocks, tb): bias-gradient rows
  int tb, np;
  int db_sdf[kMaxSdf];
};

// ---- weight gradients: C = A^T B over the points, split K ----------------

struct GemmJob {
  const __nv_bfloat16* a;  // (m, k)
  const __nv_bfloat16* b;  // (m, n)
  float* part;             // (splits, k, n)
  int m, k, n, chunk, tiles_k, tiles_n, blocks;
};

struct GemmJobs {
  GemmJob j[kMaxJobs];
  int n;
};

constexpr int kTM = 32, kTK = 64, kTN = 64, kLdT = kTK + 8;

__device__ __forceinline__ uint32_t pk(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

namespace {

__global__ void __launch_bounds__(kThreads) atb_kernel(GemmJobs jobs) {
  __shared__ __align__(16) __nv_bfloat16 as[kTM * kLdT];
  __shared__ __align__(16) __nv_bfloat16 bs[kTM * kLdT];
  int b = blockIdx.x, ji = 0;
  while (ji < jobs.n - 1 && b >= jobs.j[ji].blocks) {
    b -= jobs.j[ji].blocks;
    ++ji;
  }
  const GemmJob J = jobs.j[ji];
  const int tn = b % J.tiles_n;
  b /= J.tiles_n;
  const int tk = b % J.tiles_k, split = b / J.tiles_k;
  const int k0 = tk * kTK, n0 = tn * kTN;
  const int m_begin = split * J.chunk;
  const int m_end = min(J.m, m_begin + J.chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wk = warp & 3, wn = warp >> 2;
  const int lr = threadIdx.x >> 3, lc = (threadIdx.x & 7) << 3;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kTM) {
    uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
    if (k0 + lc < J.k)
      va = *reinterpret_cast<const uint4*>(J.a + (size_t)(m0 + lr) * J.k +
                                           k0 + lc);
    if (n0 + lc < J.n)
      vb = *reinterpret_cast<const uint4*>(J.b + (size_t)(m0 + lr) * J.n +
                                           n0 + lc);
    __syncthreads();
    *reinterpret_cast<uint4*>(as + lr * kLdT + lc) = va;
    *reinterpret_cast<uint4*>(bs + lr * kLdT + lc) = vb;
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int mr = ks * 16 + 2 * tig;
      const int kr = wk * 16 + g;
      uint32_t a[4];
      a[0] = pk(as[mr * kLdT + kr], as[(mr + 1) * kLdT + kr]);
      a[1] = pk(as[mr * kLdT + kr + 8], as[(mr + 1) * kLdT + kr + 8]);
      a[2] = pk(as[(mr + 8) * kLdT + kr], as[(mr + 9) * kLdT + kr]);
      a[3] = pk(as[(mr + 8) * kLdT + kr + 8], as[(mr + 9) * kLdT + kr + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nc = wn * 32 + j * 8 + g;
        const uint32_t b0 = pk(bs[mr * kLdT + nc], bs[(mr + 1) * kLdT + nc]);
        const uint32_t b1 =
            pk(bs[(mr + 8) * kLdT + nc], bs[(mr + 9) * kLdT + nc]);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
  }
  float* P = J.part + (size_t)split * J.k * J.n;
  const int row = k0 + wk * 16 + g;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * tig;
    if (col >= J.n) continue;
    if (row < J.k) {
      P[(size_t)row * J.n + col] = acc[j][0];
      P[(size_t)row * J.n + col + 1] = acc[j][1];
    }
    if (row + 8 < J.k) {
      P[(size_t)(row + 8) * J.n + col] = acc[j][2];
      P[(size_t)(row + 8) * J.n + col + 1] = acc[j][3];
    }
  }
}

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

// The scratch table (int64, element offsets), read in the order
// `_BwdPlan` writes it: ax, br (SDF layers), dbpart, tb, the bias
// offsets; returns the rest (the products' splits, chunks, partials and
// outputs).
inline const long long* read_scratch(const long long* t, int n_fwd, int np,
                                     void* ws16, float* ws32, Scratch& sc) {
  __nv_bfloat16* b16 = (__nv_bfloat16*)ws16;
  for (int l = 0; l < n_fwd; ++l) sc.ax[l] = b16 + *t++;
  for (int l = 0; l < n_fwd; ++l) sc.br[l] = b16 + *t++;
  sc.dbpart = ws32 + *t++;
  sc.tb = (int)*t++;
  sc.np = np;
  for (int l = 0; l < n_fwd; ++l) sc.db_sdf[l] = (int)*t++;
  return t;
}

// The weight gradients from the staged operands: every dW_p = A^T B over
// the points ([da ; X]^T [r ; dz] over 2 np rows), split over point
// ranges, then the ranges and the blocks' bias rows added in a fixed order
// into `out` (no atomics: the same result to the bit run to run). `t` is
// the rest of the table after read_scratch. K12 stacks four streams per
// SDF layer (`sdf_streams`) but one in the output layer's product
// (`out_streams`: its tangent rows' share is summed in the sweep), and
// runs 16 points a block (`block_rows`, the rows of one bias row of
// `dbpart`).
inline cudaError_t launch_wgrad(const Plan& fwd, const Scratch& sc,
                                const long long* t, float* ws32,
                                float* out, cudaStream_t st,
                                int sdf_streams, int block_rows,
                                int out_streams) {
  const int n_fwd = fwd.n, jobs_n = n_fwd;
  const long long* splits = t;
  const long long* chunk = t + jobs_n;
  const long long* part = t + 2 * jobs_n;
  const long long* outp = t + 3 * jobs_n;
  const long long out_db = t[4 * jobs_n];
  GemmJobs gj;
  SumJobs sj;
  gj.n = jobs_n;
  sj.n = jobs_n + 1;
  int gemm_blocks = 0;
  long long total = 0;
  for (int p = 0; p < jobs_n; ++p) {
    const int* L = fwd.L[p];
    GemmJob& J = gj.j[p];
    J.a = sc.ax[p];
    J.b = sc.br[p];
    J.part = ws32 + part[p];
    J.m = (p == n_fwd - 1 ? out_streams : sdf_streams) * sc.np;
    J.k = L[kK];
    J.n = L[kN];
    J.chunk = (int)chunk[p];
    J.tiles_k = (J.k + kTK - 1) / kTK;
    J.tiles_n = (J.n + kTN - 1) / kTN;
    J.blocks = J.tiles_k * J.tiles_n * (int)splits[p];
    gemm_blocks += J.blocks;
    sj.j[p] = SumJob{J.part, out + outp[p], (long long)J.k * J.n,
                     (int)splits[p]};
    total += sj.j[p].e;
  }
  const int blocks = sc.np / block_rows;
  sj.j[jobs_n] = SumJob{sc.dbpart, out + out_db, (long long)sc.tb, blocks};
  sj.total = total + sc.tb;
  atb_kernel<<<gemm_blocks, kThreads, 0, st>>>(gj);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long sum_blocks = (sj.total + kThreads - 1) / kThreads;
  sum_kernel<<<(int)(sum_blocks < 4096 ? sum_blocks : 4096), kThreads, 0,
               st>>>(sj);
  return cudaGetLastError();
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
