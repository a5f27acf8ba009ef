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

// Write scale * PE(points) into columns [col0, kend) of a bf16 row buffer,
// zero beyond the encoding's 3 + 6F columns.
__device__ __forceinline__ void write_pe(__nv_bfloat16* buf, int lda, int rows,
                                         const float* pts, int F, int col0,
                                         int kend, float scale) {
  const int width = kend - col0, d0 = 3 + 6 * F;
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, p = i % width;
    const float v = p < d0 ? pe_value(pts + 3 * r, F, p) * scale : 0.f;
    buf[r * lda + col0 + p] = __float2bfloat16_rn(v);
  }
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

// Hidden layer of the SDF net: bf16(scale * softplus100(acc + b)); with
// `dact` set, also stash bf16(softplus100'(acc + b)) for a reverse sweep.
struct EpiSoftplus {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  float scale;
  __nv_bfloat16* dact;
  int ldd;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float z0 = v0 + bias[c], z1 = v1 + bias[c + 1];
    *reinterpret_cast<uint32_t*>(out + r * lda + c) =
        pack_bf16x2(softplus100(z0) * scale, softplus100(z1) * scale);
    if (dact)
      *reinterpret_cast<uint32_t*>(dact + r * ldd + c) =
          pack_bf16x2(dsoftplus100(z0), dsoftplus100(z1));
  }
};

// ---- the SDF net's sweeps over a block of kSweepRows points (K4-K6) ------
//
// K5's kernel body (`fwd_sweep_kernel`, rev_fwd.cu) is the forward with the
// activation derivative stashed as bf16 s = softplus100'(z), then
// d sdf / d x swept back through the net. K6's (`bwd_sweep_kernel`): the
// derivative stashed as q (`stash_q`), the backward's four sweeps staging
// every layer's weight-gradient operands in device memory (`Scratch`),
// then the split-K products and the fixed-order sums (`launch_wgrad`, both
// behind `launch_bwd`). K4 (render_core_bwd.cu) runs the same sweeps on
// `wgmma_layer.cuh`.

constexpr int kSweepMT = 2;
constexpr int kSweepRows = kSweepMT * 16;
constexpr int kSweepMaxNT = 5;  // up to 8 warps * 5 tiles * 8 = 320 cols
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

// Copy `cols` (a multiple of 8) columns of the block's rows between shared
// memory (row stride lda) and device memory (row stride ld), 16 bytes a
// thread.
__device__ __forceinline__ void store_rows(const __nv_bfloat16* s, int lda,
                                           __nv_bfloat16* g, int ld, int cols,
                                           int row0) {
  const int v = cols >> 3;
  for (int i = threadIdx.x; i < kSweepRows * v; i += kThreads) {
    const int r = i / v, c = (i % v) << 3;
    *reinterpret_cast<uint4*>(g + (size_t)(row0 + r) * ld + c) =
        *reinterpret_cast<const uint4*>(s + r * lda + c);
  }
}

__device__ __forceinline__ void load_rows(__nv_bfloat16* s, int lda,
                                          const __nv_bfloat16* g, int ld,
                                          int cols, int row0) {
  const int v = cols >> 3;
  for (int i = threadIdx.x; i < kSweepRows * v; i += kThreads) {
    const int r = i / v, c = (i % v) << 3;
    *reinterpret_cast<uint4*>(s + r * lda + c) =
        *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * ld + c);
  }
}

// Hidden SDF layer of the backward's recompute: bf16(scale *
// softplus100(acc + b)), and the stash q of its derivative.
struct EpiSoftplusQ {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  float scale;
  __nv_bfloat16* q;
  int ldd;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float z0 = v0 + bias[c], z1 = v1 + bias[c + 1];
    put2(out + r * lda + c, softplus100(z0) * scale, softplus100(z1) * scale);
    put2(q + r * ldd + c, stash_q(z0), stash_q(z1));
  }
};

// ---- K6: the backward's sweep ----------------------------------------------

// Where the backward stages each layer's operands (element pointers into
// the bf16 and f32 scratch), as the host's table lays them out
// (i2sdf_tpu_torch/ops/kernels/render_core.py::_BwdPlan).
struct Scratch {
  __nv_bfloat16* ax[kMaxSdf];   // (2 np, K_l): [da_l ; X_l]
  __nv_bfloat16* br[kMaxSdf];   // (2 np, N_l): [r_l ; dz_l]
  __nv_bfloat16* dzx[kMaxSdf];  // (np, N_l): dz_extra into z_l
  float* ah[kMaxSdf];           // (np, K_l): d sdf / d h_l
  float* dbpart;                // (blocks, tb): bias-gradient rows
  int tb, np;
  int db_sdf[kMaxSdf];
};

// The block's shared memory in K6's sweep: two activation buffers, every
// hidden layer's stash q, the points, room for view directions, the
// cotangents (kCot a row, c_grad in the first three) and an rgb, the
// encoding's gradient cotangent dge and the f32 dz the bias sums take.
struct BwdSmem {
  __nv_bfloat16 *buf0, *buf1, *q;
  float *xs, *ds, *cot, *rgb, *dge, *dzf;
};

__device__ __forceinline__ BwdSmem carve_bwd(unsigned char* p, int lda,
                                             int ldd, int n_q, int ldg) {
  BwdSmem s;
  s.buf0 = reinterpret_cast<__nv_bfloat16*>(p);
  s.buf1 = s.buf0 + kSweepRows * lda;
  s.q = s.buf1 + kSweepRows * lda;
  s.xs = reinterpret_cast<float*>(s.q + (size_t)n_q * kSweepRows * ldd);
  s.ds = s.xs + kSweepRows * 3;
  s.cot = s.ds + kSweepRows * 3;
  s.rgb = s.cot + kSweepRows * kCot;
  s.dge = s.rgb + kSweepRows * 4;
  s.dzf = s.dge + kSweepRows * ldg;
  return s;
}

// Bytes of BwdSmem (the host mirrors it in `bwd_smem`).
inline size_t bwd_smem_bytes(int lda, int ldd, int n_q, int ldg) {
  return (2 * (size_t)kSweepRows * lda +
          (size_t)n_q * kSweepRows * ldd) *
             sizeof(__nv_bfloat16) +
         (size_t)kSweepRows * (3 + 3 + kCot + 4 + ldg + lda) * sizeof(float);
}

// The block's bias-gradient row: column c summed over the rows in order.
__device__ __forceinline__ void put_db(float* dst, const float* dzf, int lda,
                                       int n) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < kSweepRows; ++r) acc += dzf[r * lda + c];
    dst[c] = acc;
  }
}

// Reverse sweep through W_l^T: ah = scale * (r_l W_l^T) on the hidden
// columns (stored in f32), r_{l-1} = bf16(ah * s_{l-1}); zero elsewhere.
struct EpiRevQ {
  __nv_bfloat16* out;
  int lda;
  const __nv_bfloat16* q;
  int ldd;
  float scale;
  int n_h;
  float* ah;
  int ldah, row0;
  __device__ __forceinline__ float one(int r, int c, float v) {
    float a = 0.f, o = 0.f;
    if (c < n_h) {
      a = v * scale;
      o = a * stash_s(bf(q + r * ldd + c));
    }
    ah[(size_t)(row0 + r) * ldah + c] = a;
    return o;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put2(out + r * lda + c, one(r, c, v0), one(r, c + 1, v1));
  }
};

// Upward sweep: dr = da_l W_l is the cotangent of r_l. On the hidden
// columns, da_{l+1} = scale * dr * s_l (scale 1/sqrt(2) into a skip) and
// dz_extra_l = bf16(dr * ah_{l+1} * 100 s_l (1 - s_l)).
struct EpiUp {
  __nv_bfloat16* out;
  int lda;
  const __nv_bfloat16* q;
  int ldd;
  const float* ah;
  int ldah;
  __nv_bfloat16* dzx;
  int lddz, row0, n_h;
  float scale;
  __device__ __forceinline__ float one(int r, int c, float v, float& x) {
    if (c >= n_h) {
      x = 0.f;
      return 0.f;
    }
    const float st = bf(q + r * ldd + c);
    x = v * ah[(size_t)(row0 + r) * ldah + c] * stash_d2(st);
    return v * stash_s(st) * scale;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    float x0, x1;
    const float a0 = one(r, c, v0, x0), a1 = one(r, c + 1, v1, x1);
    put2(out + r * lda + c, a0, a1);
    put2(dzx + (size_t)(row0 + r) * lddz + c, x0, x1);
  }
};

// Downward sweep through W_l^T: on the hidden columns,
// dz_{l-1} = scale * (dz_l W_l^T) * s_{l-1} + dz_extra_{l-1}.
struct EpiDown {
  __nv_bfloat16* out;
  int lda;
  const __nv_bfloat16* q;
  int ldd;
  const __nv_bfloat16* dzx;
  int lddz, row0, n_h;
  float scale;
  float* dzf;
  __device__ __forceinline__ float one(int r, int c, float v) {
    const float d = c < n_h ? v * scale * stash_s(bf(q + r * ldd + c)) +
                                  bf(dzx + (size_t)(row0 + r) * lddz + c)
                            : 0.f;
    dzf[r * lda + c] = d;
    return d;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put2(out + r * lda + c, one(r, c, v0), one(r, c + 1, v1));
  }
};

namespace {

// K6's kernel body, 32 points a block: the SDF forward recompute (X_l to
// rows [np, 2 np) of ax[l], the stash q_l); the output layer's dz is
// c_out, in the net's own column order; the reverse sweep (r_l to rows
// [0, np) of br[l], ah_l to ah[l], from e_sdf in the output layer's sdf
// column 0); dg_emb from c_grad by the encoding's closed-form Jacobian;
// the upward sweep, the transpose of the reverse sweep (da_l to rows
// [0, np) of ax[l], the second-order term dz_extra_l = dr * ah * 100 s
// (1 - s) to dzx[l]); the downward sweep (dz_l to rows [np, 2 np) of
// br[l]) with those injections. Each hidden layer's bias row goes to the
// block's row of `dbpart`. Written out in one body, as K5's kernel is.
__global__ void __launch_bounds__(kThreads)
bwd_sweep_kernel(const float* __restrict__ x,
                 const float* __restrict__ c_out, int out_cols,
                 const float* __restrict__ c_g, int n,
                 const uint2* __restrict__ w_fwd,
                 const float* __restrict__ b_sdf, Plan fwd,
                 const uint2* __restrict__ w_t, Plan tp,
                 const float* __restrict__ wsdf_col, int mx, int lda,
                 int ldd, int ldg, Scratch sc) {
  constexpr int kMT = kSweepMT, kMaxNT = kSweepMaxNT, kRows = kSweepRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = fwd.n, nh = ns - 1;
  const BwdSmem s = carve_bwd(smem, lda, ldd, nh, ldg);
  __nv_bfloat16* buf[2] = {s.buf0, s.buf1};
  const int row0 = blockIdx.x * kRows;
  const int np = sc.np;
  const int d0 = 3 + 6 * mx;
  const int sdf_col = 0;  // the output layer in the net's order [sdf | feat]
  float* dbp = sc.dbpart + (size_t)blockIdx.x * sc.tb;

  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = row0 + i / 3;
    s.xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
  }
  // c_g in the cotangent rows' first three columns
  for (int i = threadIdx.x; i < kRows * kCot; i += kThreads) {
    const int r = row0 + i / kCot, c = i % kCot;
    s.cot[i] = (r < n && c < 3) ? c_g[(size_t)r * 3 + c] : 0.f;
  }
  __syncthreads();
  write_pe(buf[0], lda, kRows, s.xs, mx, 0, fwd.L[0][kK], 1.f);
  __syncthreads();

  // ---- 1. SDF forward: X_l to ax[l] rows [np, 2np), stash q_l ----------
  int cur = 0;
  for (int l = 0; l < ns; ++l) {
    const int* L = fwd.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe(buf[cur], lda, kRows, s.xs, mx, L[kCol], L[kK], kInvSqrt2);
      __syncthreads();
    }
    store_rows(buf[cur], lda, sc.ax[l] + (size_t)np * L[kK], L[kK], L[kK],
               row0);
    const uint2* W = w_fwd + L[kWOff];
    const float* b = b_sdf + L[kBOff];
    if (l < nh) {
      EpiSoftplusQ epi{buf[cur ^ 1], lda, b,
                       (L[kFlags] & kScale) ? kInvSqrt2 : 1.f,
                       s.q + (size_t)l * kRows * ldd, ldd};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }  // the output layer's input is all the backward needs of it
    __syncthreads();
    cur ^= 1;
  }

  const int n_last = fwd.L[ns - 1][kN];
  __nv_bfloat16* cy = sc.br[ns - 1] + (size_t)np * n_last;
  {
    // ---- 2-3. the output layer's dz is c_out, from memory ----------------
    for (int i = threadIdx.x; i < kRows * n_last; i += kThreads) {
      const int r = i / n_last, c = i % n_last;
      const float v = (row0 + r < n && c < out_cols)
                          ? c_out[(size_t)(row0 + r) * out_cols + c]
                          : 0.f;
      cy[(size_t)(row0 + r) * n_last + c] = __float2bfloat16_rn(v);
      s.dzf[r * lda + c] = v;
    }
    __syncthreads();
    put_db(dbp + sc.db_sdf[ns - 1], s.dzf, lda, n_last);
    __syncthreads();
  }

  // ---- 4. reverse sweep: r_l to br[l] rows [0, np), ah_l to ah[l] -------
  {
    for (int i = threadIdx.x; i < kRows * n_last; i += kThreads) {
      const int r = i / n_last, c = i % n_last;
      sc.br[ns - 1][(size_t)(row0 + r) * n_last + c] =
          __float2bfloat16_rn(c == sdf_col ? 1.f : 0.f);
    }
    // ah_{n-1} = W_{n-1}[:, sdf]; r_{n-2} = bf16(ah_{n-1} * s_{n-2})
    const int K = fwd.L[ns - 1][kK];
    const __nv_bfloat16* ql = s.q + (size_t)(nh - 1) * kRows * ldd;
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K, c = i % K;
      const float a = wsdf_col[c];
      sc.ah[ns - 1][(size_t)(row0 + r) * K + c] = a;
      buf[cur][r * lda + c] =
          __float2bfloat16_rn(a * stash_s(bf(ql + r * ldd + c)));
    }
    __syncthreads();
    store_rows(buf[cur], lda, sc.br[ns - 2], K, K, row0);
  }
  for (int l = ns - 2; l >= 1; --l) {
    const int* L = tp.L[ns - 1 - l];  // W_l^T
    EpiRevQ epi{buf[cur ^ 1], lda, s.q + (size_t)(l - 1) * kRows * ldd, ldd,
                (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, L[kReal], sc.ah[l],
                L[kN], row0};
    mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], w_t + L[kWOff], L[kN], epi);
    __syncthreads();
    const int N = fwd.L[l - 1][kN];
    store_rows(buf[cur ^ 1], lda, sc.br[l - 1], N, N, row0);
    cur ^= 1;
  }

  // ---- 5. dg_emb = (c_grad Sel^T) * tilde, f32 --------------------------
  for (int i = threadIdx.x; i < kRows * ldg; i += kThreads) {
    const int r = i / ldg, j = i % ldg;
    float v = 0.f;
    if (j < 3) {
      v = s.cot[r * kCot + j];
    } else if (j < d0) {
      int p = j - 3;
      const bool is_cos = p >= 3 * mx;
      if (is_cos) p -= 3 * mx;
      const int k = p / mx;
      const float f = ldexpf(1.f, p % mx);
      const float arg = s.xs[3 * r + k] * f;
      v = s.cot[r * kCot + k] * (is_cos ? -f * sinf(arg) : f * cosf(arg));
    }
    s.dge[i] = v;
  }
  __syncthreads();

  // ---- 6. upward sweep: da_l to ax[l] rows [0, np), dz_extra_l to dzx ---
  {
    const int K = fwd.L[0][kK];
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K, c = i % K;
      buf[cur][r * lda + c] =
          __float2bfloat16_rn(c < d0 ? s.dge[r * ldg + c] : 0.f);
    }
    __syncthreads();
    store_rows(buf[cur], lda, sc.ax[0], K, K, row0);
  }
  for (int l = 0; l < nh; ++l) {
    const int* L = fwd.L[l];
    const int* L1 = fwd.L[l + 1];
    EpiUp epi{buf[cur ^ 1], lda, s.q + (size_t)l * kRows * ldd, ldd,
              sc.ah[l + 1], L1[kK], sc.dzx[l], L[kN], row0, L[kReal],
              (L[kFlags] & kScale) ? kInvSqrt2 : 1.f};
    mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], w_fwd + L[kWOff], L[kN],
                           epi);
    __syncthreads();
    if (L1[kFlags] & kSkipIn) {
      const int col = L1[kCol], w = L1[kK] - col;
      for (int i = threadIdx.x; i < kRows * w; i += kThreads) {
        const int r = i / w, p = i % w;
        buf[cur ^ 1][r * lda + col + p] = __float2bfloat16_rn(
            p < d0 ? s.dge[r * ldg + p] * kInvSqrt2 : 0.f);
      }
      __syncthreads();
    }
    store_rows(buf[cur ^ 1], lda, sc.ax[l + 1], L1[kK], L1[kK], row0);
    cur ^= 1;
  }

  // ---- 7. downward sweep: dz_l to br[l] rows [np, 2np) ------------------
  __syncthreads();
  load_rows(buf[cur], lda, cy, n_last, n_last, row0);
  __syncthreads();
  for (int l = ns - 1; l >= 1; --l) {
    const int* L = tp.L[ns - 1 - l];  // W_l^T
    const int N = fwd.L[l - 1][kN];
    EpiDown epi{buf[cur ^ 1], lda, s.q + (size_t)(l - 1) * kRows * ldd, ldd,
                sc.dzx[l - 1], N, row0, L[kReal],
                (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, s.dzf};
    mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], w_t + L[kWOff], L[kN], epi);
    __syncthreads();
    store_rows(buf[cur ^ 1], lda, sc.br[l - 1] + (size_t)np * N, N, N, row0);
    put_db(dbp + sc.db_sdf[l - 1], s.dzf, lda, N);
    __syncthreads();
    cur ^= 1;
  }
}

// ---- weight gradients: C = A^T B over the points, split K ----------------

}  // namespace

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
// `_BwdPlan` writes it: ax, br, dzx, ah (SDF layers), dbpart, tb, the bias
// offsets; returns the rest (the products' splits, chunks, partials and
// outputs).
inline const long long* read_scratch(const long long* t, int n_fwd, int np,
                                     void* ws16, float* ws32, Scratch& sc) {
  __nv_bfloat16* b16 = (__nv_bfloat16*)ws16;
  for (int l = 0; l < n_fwd; ++l) sc.ax[l] = b16 + *t++;
  for (int l = 0; l < n_fwd; ++l) sc.br[l] = b16 + *t++;
  for (int l = 0; l < n_fwd; ++l, ++t) sc.dzx[l] = *t < 0 ? nullptr : b16 + *t;
  for (int l = 0; l < n_fwd; ++l, ++t) sc.ah[l] = *t < 0 ? nullptr : ws32 + *t;
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
                                int sdf_streams = 2,
                                int block_rows = kSweepRows,
                                int out_streams = 2) {
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

// K6: the sweep, then the weight-gradient products and sums, on n points
// padded to np (the arguments as `bwd_sweep_kernel`'s; `table` is the
// host's scratch table, read by `read_scratch`).
inline cudaError_t launch_bwd(const float* x, const float* c_out,
                              int out_cols, const float* c_g, int n, int np,
                              const uint2* w_fwd, const float* b_sdf,
                              const Plan& fwd, const uint2* w_t,
                              const Plan& tp, const float* wsdf_col, int mx,
                              int lda, int ldd, int ldg, void* ws16,
                              float* ws32, const long long* table,
                              float* out, void* stream) {
  Scratch sc;
  const long long* rest = read_scratch(table, fwd.n, np, ws16, ws32, sc);
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = bwd_smem_bytes(lda, ldd, fwd.n - 1, ldg);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  bwd_sweep_kernel<<<np / kSweepRows, kThreads, smem, st>>>(
      x, c_out, out_cols, c_g, n, w_fwd, b_sdf, fwd, w_t, tp, wsdf_col, mx,
      lda, ldd, ldg, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_wgrad(fwd, sc, rest, ws32, out, st);
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
