// Shared device code for the port's kernels (sm_90a, plain C interface).
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
enum LayerField { kK = 0, kN, kReal, kWOff, kBOff, kFlags, kCol, kSpare };
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

// ---- the SDF net's sweeps over a block of kSweepRows points (K3-K6) ------
//
// K3 and K5 are one kernel body (`fwd_sweep_kernel`): the forward with
// the activation derivative stashed as bf16 s = softplus100'(z), then
// d sdf / d x swept back through the net. K4 and K6 are another
// (`bwd_sweep_kernel`): the derivative stashed as q (`stash_q`), the
// backward's four sweeps staging every layer's weight-gradient operands in
// device memory (`Scratch`), then the split-K products and the fixed-order
// sums (`launch_wgrad`, both behind `launch_bwd`). The light head of the
// light-mask config is a second template flag of K3's and K4's kernels
// (`kLight`): its code sits under `if constexpr`, so the kernels without
// it compile as they did before it.

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

// The light net's plan rows (`L`, layer 0 first) and those of its
// transpose (`T`, last layer first), kept apart from `Plan` so that the
// kernels' parameters stay small.
struct LightPlan {
  int n;
  int L[kMaxLight][8];
  int T[kMaxLight][8];
};

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

// ---- K3 and K5: the SDF net's outputs and d sdf / d x ----------------------

// Reverse layer: a = r_l @ W_l^T is d sdf / d (input of layer l). Columns
// below n_h continue down the net: r_{l-1} = bf16(scale * a * dact_{l-1});
// columns [gcol, gcol + d0) belong to the encoding and are added, scaled,
// into gpe (f32). Padding columns are written as zeros.
struct EpiRev {
  __nv_bfloat16* out;
  int lda;
  const __nv_bfloat16* dact;
  int ldd;
  float scale;
  int n_h, gcol, d0;
  float* gpe;
  int ldg;
  __device__ __forceinline__ float one(int r, int c, float v, float d) {
    v *= scale;
    if (c < n_h) return v * d;
    const int p = c - gcol;
    if (p >= 0 && p < d0) gpe[r * ldg + p] += v;
    return 0.f;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    float2 d = make_float2(0.f, 0.f);
    if (c < n_h)
      d = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(dact + r * ldd + c));
    put2(out + r * lda + c, one(r, c, v0, d.x), one(r, c + 1, v1, d.y));
  }
};

// The light net's input: relu of the F feature columns of `feat`, zero up
// to the first light layer's depth K.
__device__ __forceinline__ void light_input(__nv_bfloat16* dst, int lda,
                                            const __nv_bfloat16* feat, int F,
                                            int K) {
  for (int i = threadIdx.x; i < kSweepRows * K; i += kThreads) {
    const int r = i / K, c = i % K;
    dst[r * lda + c] = __float2bfloat16_rn(
        c < F ? fmaxf(bf(feat + r * lda + c), 0.f) : 0.f);
  }
}

// K3's output layer, columns [features (F) | sdf]: the features to the
// radiance input buffer (no activation), sdf to shared memory.
struct EpiFeatSdf {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  float* sdf_s;
  int F;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float z0 = v0 + bias[c], z1 = v1 + bias[c + 1];
    if (c < F) {
      put2(out + r * lda + c, z0, z1);
    } else if (c == F) {
      sdf_s[r] = z0;
    }
  }
};

// K5's output layer: columns [0, out_cols) of rows below n to device
// memory, in the net's own order.
struct EpiOut {
  float* out;
  const float* bias;
  int row0, n, out_cols;
  __device__ __forceinline__ void put(int r, int c, float v) {
    if (c < out_cols && row0 + r < n)
      out[(size_t)(row0 + r) * out_cols + c] = v + bias[c];
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put(r, c, v0);
    put(r, c + 1, v1);
  }
};

struct EpiRelu {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put2(out + r * lda + c, fmaxf(v0 + bias[c], 0.f),
         fmaxf(v1 + bias[c + 1], 0.f));
  }
};

// K3's rgb: sigmoid of the radiance net's output, rows below n.
struct EpiRgbOut {
  float* rgb;
  const float* bias;
  int row0, n, d_out;
  __device__ __forceinline__ void put(int r, int c, float v) {
    if (c < d_out && row0 + r < n)
      rgb[(size_t)(row0 + r) * d_out + c] = 1.f / (1.f + expf(-(v + bias[c])));
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put(r, c, v0);
    put(r, c + 1, v1);
  }
};

// K3's light head: the light net on relu(features) in `in`, ping-ponging
// with `tmp` (both kSweepRows x lda), its sigmoid output to rows [row0, n)
// of `lmask_out`. Out of line and at the kernel's end: inlined after the
// SDF output layer it raised the whole kernel's register spills from 20
// to 104 bytes and K3's time by ~28% (at its end, 52 bytes and ~19%); out
// of line K3 keeps its 20 bytes, and the head costs ~10% (H100,
// scripts/time_render_core.py --light).
static __device__ __noinline__ void light_forward(
    __nv_bfloat16* in, __nv_bfloat16* tmp, int lda,
    const uint2* __restrict__ w_l, const float* __restrict__ b_l,
    LightPlan lp, float* __restrict__ lmask_out, int row0, int n) {
  __nv_bfloat16* lbuf[2] = {in, tmp};
  for (int l = 0; l < lp.n; ++l) {
    const int* L = lp.L[l];
    const uint2* W = w_l + L[kWOff];
    const float* b = b_l + L[kBOff];
    if (l < lp.n - 1) {
      EpiSoftplus epi{lbuf[(l & 1) ^ 1], lda, b, 1.f, nullptr, 0};
      mma_layer<kSweepMT, kSweepMaxNT>(lbuf[l & 1], lda, L[kK], W, L[kN],
                                       epi);
    } else {
      EpiRgbOut epi{lmask_out, b, row0, n, 1};
      mma_layer<kSweepMT, kSweepMaxNT>(lbuf[l & 1], lda, L[kK], W, L[kN],
                                       epi);
    }
    __syncthreads();
  }
}

// Shared memory of `fwd_sweep_kernel` (bytes): two activation buffers,
// every hidden layer's activation derivative, and per row the point, the
// view direction, the sdf and the encoding's gradient; with the light
// head, a third activation buffer at the end.
inline size_t fwd_smem_bytes(int lda, int ldd, int n_dact, int ldg,
                             bool light) {
  return ((2 + light) * (size_t)kSweepRows * lda +
          (size_t)n_dact * kSweepRows * ldd) *
             sizeof(__nv_bfloat16) +
         (size_t)kSweepRows * (3 + 3 + 1 + ldg) * sizeof(float);
}

namespace {

// K3 (`kRadiance`) and K5 in one kernel body. A block of 32 points runs
// the SDF net forward with its activations in shared memory, stashing each
// hidden layer's activation derivative (bf16 s = softplus100'(z)). K3's
// output layer keeps the features in shared memory for the radiance net
// on [features | PE(dirs)] and the sdf for its output; K5's writes its
// columns to device memory. Then d sdf / d h goes back through the
// transposed hidden layers (`rev`, rev.L[i] is hidden layer
// n_hidden-1-i), starting from r = W_last[:, sdf] * dact (`wsdf_col`, zero
// padded to the next layer's depth), the encoding's share gathered at
// layer 0 and at the skip into gpe (f32), and the closed-form Jacobian of
// the wide-block encoding, d sin(f x)/dx = f cos(f x), d cos(f x)/dx =
// -f sin(f x), gives d sdf / d x. The sweeps are written out in one kernel
// body, in K3's own form (an indexed pair of buffers, restrict-qualified
// kernel arguments): as device functions shared by two kernels, or with
// the buffers selected instead of indexed, K3 ran measurably slower on
// the H100. With `kLight` (K3 of the light-mask config), relu(features)
// is copied to a third buffer right after the SDF net's output layer, and
// at the end the light net runs on it (`light_forward`), its sigmoid
// output to `lmask_out`.
template <bool kRadiance, bool kLight>
__global__ void __launch_bounds__(kThreads)
fwd_sweep_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                 int n, const uint2* __restrict__ w_fwd,
                 const float* __restrict__ b_sdf, Plan fwd,
                 const uint2* __restrict__ w_rev, Plan rev,
                 const float* __restrict__ wsdf_col,
                 const uint2* __restrict__ w_rad,
                 const float* __restrict__ b_rad, Plan rad,
                 const uint2* __restrict__ w_l,
                 const float* __restrict__ b_l, LightPlan lp, int mx, int md,
                 int lda, int ldd, int ldg, int out_cols,
                 float* __restrict__ sdf_out, float* __restrict__ grad_out,
                 float* __restrict__ rgb_out, float* __restrict__ lmask_out,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_hidden = fwd.n - 1;
  __nv_bfloat16* buf[2];
  buf[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  buf[1] = buf[0] + kSweepRows * lda;
  __nv_bfloat16* dact = buf[1] + kSweepRows * lda;
  float* xs = reinterpret_cast<float*>(dact + (size_t)n_hidden * kSweepRows *
                                                  ldd);
  float* ds = xs + kSweepRows * 3;
  float* sdf_s = ds + kSweepRows * 3;
  float* gpe = sdf_s + kSweepRows;
  const int row0 = blockIdx.x * kSweepRows;
  const int d0x = 3 + 6 * mx;
  const int F = fwd.L[fwd.n - 1][kReal] - 1;  // feature width

  for (int i = threadIdx.x; i < kSweepRows * 3; i += kThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
    if (kRadiance) ds[i] = r < n ? dirs[(size_t)r * 3 + i % 3] : 0.f;
  }
  for (int i = threadIdx.x; i < kSweepRows * ldg; i += kThreads) gpe[i] = 0.f;
  __syncthreads();
  write_pe(buf[0], lda, kSweepRows, xs, mx, 0, fwd.L[0][kK], 1.f);
  __syncthreads();

  // ---- SDF forward, stashing activation derivatives --------------------
  int cur = 0;
  for (int l = 0; l < fwd.n; ++l) {
    const int* L = fwd.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe(buf[cur], lda, kSweepRows, xs, mx, L[kCol], L[kK], kInvSqrt2);
      __syncthreads();
    }
    const uint2* W = w_fwd + L[kWOff];
    const float* b = b_sdf + L[kBOff];
    if (l < n_hidden) {
      EpiSoftplus epi{buf[cur ^ 1], lda, b,
                      (L[kFlags] & kScale) ? kInvSqrt2 : 1.f,
                      dact + (size_t)l * kSweepRows * ldd, ldd};
      mma_layer<kSweepMT, kSweepMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else if (kRadiance) {
      EpiFeatSdf epi{buf[cur ^ 1], lda, b, sdf_s, F};
      mma_layer<kSweepMT, kSweepMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiOut epi{out, b, row0, n, out_cols};
      mma_layer<kSweepMT, kSweepMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- K3 with the light head: keep relu(features) for the light net ----
  if constexpr (kLight) {
    __nv_bfloat16* lb =
        reinterpret_cast<__nv_bfloat16*>(gpe + kSweepRows * ldg);
    light_input(lb, lda, buf[cur], F, lp.L[0][kK]);
  }

  // ---- K3: radiance net on [features | PE(dirs)] --------------------------
  if (kRadiance) {
    write_pe(buf[cur], lda, kSweepRows, ds, md, F, rad.L[0][kK], 1.f);
    __syncthreads();
    for (int l = 0; l < rad.n; ++l) {
      const int* L = rad.L[l];
      const uint2* W = w_rad + L[kWOff];
      const float* b = b_rad + L[kBOff];
      if (l < rad.n - 1) {
        EpiRelu epi{buf[cur ^ 1], lda, b};
        mma_layer<kSweepMT, kSweepMaxNT>(buf[cur], lda, L[kK], W, L[kN],
                                         epi);
      } else {
        EpiRgbOut epi{rgb_out, b, row0, n, L[kReal]};
        mma_layer<kSweepMT, kSweepMaxNT>(buf[cur], lda, L[kK], W, L[kN],
                                         epi);
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  // ---- reverse sweep: d sdf / d x --------------------------------------
  {
    const int K = rev.L[0][kK];
    const __nv_bfloat16* dl = dact + (size_t)(n_hidden - 1) * kSweepRows * ldd;
    for (int i = threadIdx.x; i < kSweepRows * K; i += kThreads) {
      const int r = i / K, c = i % K;
      buf[cur][r * lda + c] =
          __float2bfloat16_rn(wsdf_col[c] * bf(dl + r * ldd + c));
    }
  }
  __syncthreads();
  for (int i = 0; i < rev.n; ++i) {
    const int* L = rev.L[i];
    const int l = n_hidden - 1 - i;
    EpiRev epi{buf[cur ^ 1], lda,
               l > 0 ? dact + (size_t)(l - 1) * kSweepRows * ldd : nullptr,
               ldd, (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, L[kReal], L[kCol],
               d0x, gpe, ldg};
    mma_layer<kSweepMT, kSweepMaxNT>(buf[cur], lda, L[kK],
                                     w_rev + L[kWOff], L[kN], epi);
    __syncthreads();
    cur ^= 1;
  }

  // ---- encoding Jacobian, outputs --------------------------------------
  for (int i = threadIdx.x; i < kSweepRows * 3; i += kThreads) {
    const int r = i / 3, d = i % 3;
    if (row0 + r >= n) continue;
    const float* gp = gpe + r * ldg;
    const float xd = xs[3 * r + d];
    float g = gp[d];
    for (int j = 0; j < mx; ++j) {
      const float f = ldexpf(1.f, j);
      g += f * (gp[3 + d * mx + j] * cosf(xd * f) -
                gp[3 + 3 * mx + d * mx + j] * sinf(xd * f));
    }
    grad_out[(size_t)(row0 + r) * 3 + d] = g;
    if (kRadiance && d == 0) sdf_out[row0 + r] = sdf_s[r];
  }
  // ---- K3 with the light head: the light net ----------------------------
  if constexpr (kLight) {
    __syncthreads();
    light_forward(reinterpret_cast<__nv_bfloat16*>(gpe + kSweepRows * ldg),
                  buf[0], lda, w_l, b_l, lp, lmask_out, row0, n);
  }
}

// Launch `fwd_sweep_kernel` on n points (the arguments as the kernel's);
// returns the launch's error.
template <bool kRadiance, bool kLight>
inline cudaError_t launch_fwd_sweep(
    const float* x, const float* dirs, int n, const uint2* w_fwd,
    const float* b_sdf, const Plan& fwd, const uint2* w_rev, const Plan& rev,
    const float* wsdf_col, const uint2* w_rad, const float* b_rad,
    const Plan& rad, const uint2* w_l, const float* b_l, const LightPlan& lp,
    int mx, int md, int lda, int ldd, int ldg, int out_cols, float* sdf_out,
    float* grad_out, float* rgb_out, float* lmask_out, float* out,
    void* stream) {
  const size_t smem = fwd_smem_bytes(lda, ldd, fwd.n - 1, ldg, kLight);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_sweep_kernel<kRadiance, kLight>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kSweepRows - 1) / kSweepRows;
  fwd_sweep_kernel<kRadiance, kLight>
      <<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
          x, dirs, n, w_fwd, b_sdf, fwd, w_rev, rev, wsdf_col, w_rad, b_rad,
          rad, w_l, b_l, lp, mx, md, lda, ldd, ldg, out_cols, sdf_out,
          grad_out, rgb_out, lmask_out, out);
  return cudaGetLastError();
}

}  // namespace

// ---- K4 and K6: the backward's sweeps -------------------------------------

// Where the backward stages each layer's operands (element pointers into
// the bf16 and f32 scratch), as the host's table lays them out
// (i2sdf_tpu_torch/ops/kernels/render_core.py::_BwdPlan).
struct Scratch {
  __nv_bfloat16* ax[kMaxSdf];   // (2 np, K_l): [da_l ; X_l]
  __nv_bfloat16* br[kMaxSdf];   // (2 np, N_l): [r_l ; dz_l]
  __nv_bfloat16* dzx[kMaxSdf];  // (np, N_l): dz_extra into z_l
  float* ah[kMaxSdf];           // (np, K_l): d sdf / d h_l
  __nv_bfloat16* rx[kMaxRad];   // (np, K_L): radiance layer inputs
  __nv_bfloat16* rdz[kMaxRad];  // (np, N_L): radiance output cotangents
  __nv_bfloat16* lx[kMaxLight];   // (np, K): light layer inputs
  __nv_bfloat16* ldz[kMaxLight];  // (np, N): light output cotangents (a
                                  // hidden layer's s until they replace it)
  float* dbpart;                // (blocks, tb): bias-gradient rows
  int tb, np;
  int db_sdf[kMaxSdf];
  int db_rad[kMaxRad];
  int db_light[kMaxLight];
};

// The block's shared memory in the backward's sweep: two activation
// buffers, every hidden layer's stash q, the points, the view directions,
// the cotangents [c_grad | c_sdf | c_rgb | c_lm] (kCot a row), the rgb,
// the encoding's gradient cotangent dge and the f32 dz the bias sums
// take; with the light head, a third activation buffer `lb` at the end.
struct BwdSmem {
  __nv_bfloat16 *buf0, *buf1, *q;
  float *xs, *ds, *cot, *rgb, *dge, *dzf;
  __nv_bfloat16* lb;
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
  s.lb = reinterpret_cast<__nv_bfloat16*>(s.dzf + kSweepRows * lda);
  return s;
}

// Bytes of BwdSmem (the host mirrors it in `bwd_smem`).
inline size_t bwd_smem_bytes(int lda, int ldd, int n_q, int ldg,
                             bool light) {
  return ((2 + light) * (size_t)kSweepRows * lda +
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

// K4's output layer, columns [features | sdf]: the features become the
// radiance input; the sdf value itself is not needed here.
struct EpiFeat {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  int F;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    if (c < F) put2(out + r * lda + c, v0 + bias[c], v1 + bias[c + 1]);
  }
};

// K4's rgb, to shared memory (kSweepRows x 4).
struct EpiRgbShared {
  float* rgb;
  const float* bias;
  int d_out;
  __device__ __forceinline__ void put(int r, int c, float v) {
    if (c < d_out) rgb[r * 4 + c] = 1.f / (1.f + expf(-(v + bias[c])));
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put(r, c, v0);
    put(r, c + 1, v1);
  }
};

// Radiance backward through a hidden layer's input: dz = dh * (x > 0),
// the ReLU mask read back from the layer's stored input.
struct EpiRadBack {
  __nv_bfloat16* out;
  int lda;
  const __nv_bfloat16* x;
  int ldx, row0;
  float* dzf;  // kSweepRows x lda f32, shared: the values the bias sums take
  __device__ __forceinline__ float one(int r, int c, float v) {
    const float d = bf(x + (size_t)(row0 + r) * ldx + c) > 0.f ? v : 0.f;
    dzf[r * lda + c] = d;
    return d;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put2(out + r * lda + c, one(r, c, v0), one(r, c + 1, v1));
  }
};

// Radiance backward into its first layer's input [features | PE(view)]:
// the feature columns are the cotangent of the SDF output's features.
struct EpiFeatCot {
  __nv_bfloat16* out;  // device memory: dz of the last SDF layer
  int ld, row0, F;
  float* dzf;
  int lda;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    if (c >= F) return;
    put2(out + (size_t)(row0 + r) * ld + c, v0, v1);
    dzf[r * lda + c] = v0;
    dzf[r * lda + c + 1] = v1;
  }
};

// ---- K4's light head ---------------------------------------------------

// A hidden light layer in K4's forward: bf16(softplus100(acc + b)) to
// shared memory, and its first-order derivative s = softplus100'(z) to
// the layer's dz staging in device memory, where the backward reads it
// (the light net's input is not differentiated with respect to x, so no
// second-order stash is needed).
struct EpiSoftplusS {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  __nv_bfloat16* s;
  int lds, row0;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float z0 = v0 + bias[c], z1 = v1 + bias[c + 1];
    put2(out + r * lda + c, softplus100(z0), softplus100(z1));
    put2(s + (size_t)(row0 + r) * lds + c, dsoftplus100(z0),
         dsoftplus100(z1));
  }
};

// K4's light output layer: lm = sigmoid(acc + b) in column 0 and its
// cotangent dz = c_lm lm (1 - lm), zero elsewhere: bf16 to shared memory
// (the transposed layer's operand) and to the layer's dz staging, f32 to
// dzf for the bias sums.
struct EpiLightDz {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  const float* cot;
  float* dzf;
  __nv_bfloat16* dz;
  int ldz, row0;
  __device__ __forceinline__ float one(int r, int c, float v) {
    float d = 0.f;
    if (c == 0) {
      const float lm = 1.f / (1.f + expf(-(v + bias[0])));
      d = cot[r * kCot + 7] * lm * (1.f - lm);
    }
    dzf[r * lda + c] = d;
    return d;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float d0 = one(r, c, v0), d1 = one(r, c + 1, v1);
    put2(out + r * lda + c, d0, d1);
    put2(dz + (size_t)(row0 + r) * ldz + c, d0, d1);
  }
};

// Light backward through a hidden layer's activation: dz = dh * s, s read
// from the layer's dz staging and dz written back in its place; bf16 to
// shared memory for the next transposed layer, f32 to dzf.
struct EpiLightBack {
  __nv_bfloat16* out;
  int lda;
  __nv_bfloat16* dz;
  int ldz, row0;
  float* dzf;
  __device__ __forceinline__ float one(int r, int c, float v) {
    const float d = v * bf(dz + (size_t)(row0 + r) * ldz + c);
    dzf[r * lda + c] = d;
    return d;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float d0 = one(r, c, v0), d1 = one(r, c + 1, v1);
    put2(out + r * lda + c, d0, d1);
    put2(dz + (size_t)(row0 + r) * ldz + c, d0, d1);
  }
};

// With the light features not detached: the light net's input cotangent
// dz_0 W_0^T, gated by relu'(features) (read back from the radiance net's
// stored input [features | PE]), joins the features' cotangent from the
// radiance net in f32 (dzf), and the sum replaces the bf16 cotangent of
// the SDF output layer in device memory.
struct EpiLightFeat {
  __nv_bfloat16* out;
  int ld, row0, F;
  float* dzf;
  int lda;
  const __nv_bfloat16* x;
  int ldx;
  __device__ __forceinline__ float one(int r, int c, float v) {
    const bool on = bf(x + (size_t)(row0 + r) * ldx + c) > 0.f;
    const float d = dzf[r * lda + c] + (on ? v : 0.f);
    dzf[r * lda + c] = d;
    return d;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    if (c >= F) return;
    const float d0 = one(r, c, v0), d1 = one(r, c + 1, v1);
    put2(out + (size_t)(row0 + r) * ld + c, d0, d1);
  }
};

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

// K4 (`kRadiance`) and K6 in one kernel body, 32 points a block: the SDF
// forward recompute (X_l to rows [np, 2 np) of ax[l], the stash q_l);
// K4's radiance forward and backward, which give the output layer's dz
// (K6 reads it from c_out, in the net's own column order); the reverse
// sweep (r_l to rows [0, np) of br[l], ah_l to ah[l], from e_sdf in the
// output layer's sdf column); dg_emb from c_grad by the encoding's
// closed-form Jacobian; the upward sweep, the transpose of the reverse
// sweep (da_l to rows [0, np) of ax[l], the second-order term dz_extra_l
// = dr * ah * 100 s (1 - s) to dzx[l]); the downward sweep (dz_l to rows
// [np, 2 np) of br[l]) with those injections. Each hidden layer's bias
// row goes to the block's row of `dbpart`. Written out in one body, in
// K4's own form, as K3's and K5's kernel is.
//
// With `kLight` (K4 of the light-mask config), step 1b runs the light net
// on relu(features) between `lb` and the free buffer of the pair (X_l to
// lx[l], a hidden layer's s to ldz[l]), its output's cotangent dz = c_lm
// lm (1 - lm), and the light backward through its hidden layers (dz_l to
// ldz[l]), before the radiance net needs the features. Unless
// `detach_light`, the light net's input cotangent, gated by relu'(feat),
// joins the features' cotangent at the end of step 3.
template <bool kRadiance, bool kLight>
__global__ void __launch_bounds__(kThreads)
bwd_sweep_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                 const float* __restrict__ cot,
                 const float* __restrict__ c_out, int out_cols,
                 const float* __restrict__ c_g, int n,
                 const uint2* __restrict__ w_fwd,
                 const float* __restrict__ b_sdf, Plan fwd,
                 const uint2* __restrict__ w_t, Plan tp,
                 const float* __restrict__ wsdf_col,
                 const uint2* __restrict__ w_rad,
                 const float* __restrict__ b_rad, Plan rad,
                 const uint2* __restrict__ w_radt, Plan radt,
                 const uint2* __restrict__ w_l,
                 const float* __restrict__ b_l,
                 const uint2* __restrict__ w_lt, LightPlan lp,
                 int detach_light, int mx, int md, int lda, int ldd, int ldg,
                 Scratch sc) {
  constexpr int kMT = kSweepMT, kMaxNT = kSweepMaxNT, kRows = kSweepRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = fwd.n, nh = ns - 1, nr = rad.n;
  const BwdSmem s = carve_bwd(smem, lda, ldd, nh, ldg);
  __nv_bfloat16* buf[2] = {s.buf0, s.buf1};
  const int row0 = blockIdx.x * kRows;
  const int np = sc.np;
  const int d0 = 3 + 6 * mx;
  const int F = fwd.L[ns - 1][kReal] - 1;
  // the output layer's sdf column: K4's layout is [features | sdf], K6's
  // the net's own [sdf | features]
  const int sdf_col = kRadiance ? F : 0;
  float* dbp = sc.dbpart + (size_t)blockIdx.x * sc.tb;

  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = row0 + i / 3;
    s.xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
    if (kRadiance) s.ds[i] = r < n ? dirs[(size_t)r * 3 + i % 3] : 0.f;
  }
  // [c_grad | c_sdf | c_rgb | c_lm] a row (K6: c_g only)
  for (int i = threadIdx.x; i < kRows * kCot; i += kThreads) {
    const int r = row0 + i / kCot, c = i % kCot;
    if (kRadiance)
      s.cot[i] = r < n ? cot[(size_t)r * kCot + c] : 0.f;
    else
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
    } else if (kRadiance) {
      EpiFeat epi{buf[cur ^ 1], lda, b, F};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }  // K6 needs only the output layer's input
    __syncthreads();
    cur ^= 1;
  }

  // ---- 1b. the light head: forward, and backward to its input ----------
  if constexpr (kLight) {
    const int nl = lp.n;
    light_input(s.lb, lda, buf[cur], F, lp.L[0][kK]);
    __syncthreads();
    // layer l reads lbuf[l & 1] and writes lbuf[(l & 1) ^ 1]
    __nv_bfloat16* lbuf[2] = {s.lb, buf[cur ^ 1]};
    for (int l = 0; l < nl; ++l) {
      const int* L = lp.L[l];
      const uint2* W = w_l + L[kWOff];
      const float* b = b_l + L[kBOff];
      store_rows(lbuf[l & 1], lda, sc.lx[l], L[kK], L[kK], row0);
      if (l < nl - 1) {
        EpiSoftplusS epi{lbuf[(l & 1) ^ 1], lda, b, sc.ldz[l], L[kN], row0};
        mma_layer<kMT, kMaxNT>(lbuf[l & 1], lda, L[kK], W, L[kN], epi);
      } else {
        EpiLightDz epi{lbuf[(l & 1) ^ 1], lda, b, s.cot, s.dzf, sc.ldz[l],
                       L[kN], row0};
        mma_layer<kMT, kMaxNT>(lbuf[l & 1], lda, L[kK], W, L[kN], epi);
      }
      __syncthreads();
    }
    put_db(dbp + sc.db_light[nl - 1], s.dzf, lda, lp.L[nl - 1][kN]);
    __syncthreads();
    // dz_l sits in lbuf[(l & 1) ^ 1]; dz_{l-1} goes to lbuf[l & 1]
    for (int l = nl - 1; l >= 1; --l) {
      const int* L = lp.T[nl - 1 - l];  // W_l^T
      const int N = lp.L[l - 1][kN];
      EpiLightBack epi{lbuf[l & 1], lda, sc.ldz[l - 1], N, row0, s.dzf};
      mma_layer<kMT, kMaxNT>(lbuf[(l & 1) ^ 1], lda, L[kK], w_lt + L[kWOff],
                             L[kN], epi);
      __syncthreads();
      put_db(dbp + sc.db_light[l - 1], s.dzf, lda, N);
      __syncthreads();
    }
  }

  const int n_last = fwd.L[ns - 1][kN];
  __nv_bfloat16* cy = sc.br[ns - 1] + (size_t)np * n_last;
  if (kRadiance) {
    // ---- 2. radiance forward: X_L to rx[L], rgb to shared memory --------
    write_pe(buf[cur], lda, kRows, s.ds, md, F, rad.L[0][kK], 1.f);
    __syncthreads();
    for (int l = 0; l < nr; ++l) {
      const int* L = rad.L[l];
      store_rows(buf[cur], lda, sc.rx[l], L[kK], L[kK], row0);
      const uint2* W = w_rad + L[kWOff];
      const float* b = b_rad + L[kBOff];
      if (l < nr - 1) {
        EpiRelu epi{buf[cur ^ 1], lda, b};
        mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
      } else {
        EpiRgbShared epi{s.rgb, b, L[kReal]};
        mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
      }
      __syncthreads();
      cur ^= 1;
    }

    // ---- 3. radiance backward -------------------------------------------
    {
      const int N = rad.L[nr - 1][kN], d_out = rad.L[nr - 1][kReal];
      for (int i = threadIdx.x; i < kRows * N; i += kThreads) {
        const int r = i / N, c = i % N;
        float v = 0.f;
        if (c < d_out) {
          const float g = s.rgb[r * 4 + c];
          v = s.cot[r * kCot + 4 + c] * g * (1.f - g);
        }
        s.dzf[r * lda + c] = v;
        buf[cur][r * lda + c] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      store_rows(buf[cur], lda, sc.rdz[nr - 1], N, N, row0);
      put_db(dbp + sc.db_rad[nr - 1], s.dzf, lda, N);
      __syncthreads();
    }
    for (int l = nr - 1; l >= 0; --l) {
      const int* L = radt.L[nr - 1 - l];  // W_l^T
      const uint2* W = w_radt + L[kWOff];
      if (l > 0) {
        EpiRadBack epi{buf[cur ^ 1], lda, sc.rx[l], L[kN], row0, s.dzf};
        mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
        __syncthreads();
        const int N = rad.L[l - 1][kN];
        store_rows(buf[cur ^ 1], lda, sc.rdz[l - 1], N, N, row0);
        put_db(dbp + sc.db_rad[l - 1], s.dzf, lda, N);
        __syncthreads();
        cur ^= 1;
      } else {
        EpiFeatCot epi{cy, n_last, row0, F, s.dzf, lda};
        mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
        // the sdf column carries c_sdf; padding columns are zero
        for (int i = threadIdx.x; i < kRows * (n_last - F); i += kThreads) {
          const int r = i / (n_last - F), c = F + i % (n_last - F);
          const float v = c == F ? s.cot[r * kCot + 3] : 0.f;
          cy[(size_t)(row0 + r) * n_last + c] = __float2bfloat16_rn(v);
          s.dzf[r * lda + c] = v;
        }
        __syncthreads();
        if constexpr (kLight) {
          if (!detach_light) {
            const int* L = lp.T[lp.n - 1];  // W_0^T
            load_rows(buf[cur ^ 1], lda, sc.ldz[0], L[kK], L[kK], row0);
            __syncthreads();
            EpiLightFeat epi{cy,     n_last,    row0, F, s.dzf,
                             lda,    sc.rx[0],  rad.L[0][kK]};
            mma_layer<kMT, kMaxNT>(buf[cur ^ 1], lda, L[kK], w_lt + L[kWOff],
                                   L[kN], epi);
            __syncthreads();
          }
        }
        put_db(dbp + sc.db_sdf[ns - 1], s.dzf, lda, n_last);
        __syncthreads();
      }
    }
  } else {
    // ---- 2-3. K6: the output layer's dz is c_out, from memory ----------
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
// `_BwdPlan` writes it: ax, br, dzx, ah (SDF layers), rx, rdz (radiance
// layers), lx, ldz (light layers), dbpart, tb, the bias offsets; returns
// the rest (the products' splits, chunks, partials and outputs).
inline const long long* read_scratch(const long long* t, int n_fwd,
                                     int n_rad, int n_light, int np,
                                     void* ws16, float* ws32, Scratch& sc) {
  __nv_bfloat16* b16 = (__nv_bfloat16*)ws16;
  for (int l = 0; l < n_fwd; ++l) sc.ax[l] = b16 + *t++;
  for (int l = 0; l < n_fwd; ++l) sc.br[l] = b16 + *t++;
  for (int l = 0; l < n_fwd; ++l, ++t) sc.dzx[l] = *t < 0 ? nullptr : b16 + *t;
  for (int l = 0; l < n_fwd; ++l, ++t) sc.ah[l] = *t < 0 ? nullptr : ws32 + *t;
  for (int l = 0; l < n_rad; ++l) sc.rx[l] = b16 + *t++;
  for (int l = 0; l < n_rad; ++l) sc.rdz[l] = b16 + *t++;
  for (int l = 0; l < n_light; ++l) sc.lx[l] = b16 + *t++;
  for (int l = 0; l < n_light; ++l) sc.ldz[l] = b16 + *t++;
  sc.dbpart = ws32 + *t++;
  sc.tb = (int)*t++;
  sc.np = np;
  for (int l = 0; l < n_fwd; ++l) sc.db_sdf[l] = (int)*t++;
  for (int l = 0; l < n_rad; ++l) sc.db_rad[l] = (int)*t++;
  for (int l = 0; l < n_light; ++l) sc.db_light[l] = (int)*t++;
  return t;
}

// The weight gradients from the staged operands: every dW_p = A^T B over
// the points (SDF layer: [da ; X]^T [r ; dz] over 2 np rows; radiance and
// light layer: X^T dz over np rows), split over point ranges, then the
// ranges and the blocks' bias rows added in a fixed order into `out` (no
// atomics: the same result to the bit run to run). `t` is the rest of the
// table after read_scratch. K12 stacks four streams per SDF layer
// (`sdf_streams`) but one in the output layer's product (`out_streams`:
// its tangent rows' share is summed in the sweep), and runs 16 points a
// block (`block_rows`, the rows of one bias row of `dbpart`).
inline cudaError_t launch_wgrad(const Plan& fwd, const Plan* rad,
                                const LightPlan* light, const Scratch& sc,
                                const long long* t, float* ws32, float* out,
                                cudaStream_t st, int sdf_streams = 2,
                                int block_rows = kSweepRows,
                                int out_streams = 2) {
  const int n_fwd = fwd.n, n_rad = rad ? rad->n : 0;
  const int n_light = light ? light->n : 0;
  const int jobs_n = n_fwd + n_rad + n_light;
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
    const bool is_sdf = p < n_fwd, is_rad = !is_sdf && p < n_fwd + n_rad;
    const int q = p - n_fwd - n_rad;  // light layer
    const int* L = is_sdf ? fwd.L[p] : is_rad ? rad->L[p - n_fwd] : light->L[q];
    GemmJob& J = gj.j[p];
    J.a = is_sdf ? sc.ax[p] : is_rad ? sc.rx[p - n_fwd] : sc.lx[q];
    J.b = is_sdf ? sc.br[p] : is_rad ? sc.rdz[p - n_fwd] : sc.ldz[q];
    J.part = ws32 + part[p];
    J.m = (!is_sdf ? 1 : p == n_fwd - 1 ? out_streams : sdf_streams) *
          sc.np;
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

// K4 or K6: the sweep, then the weight-gradient products and sums, on n
// points padded to np (the arguments as `bwd_sweep_kernel`'s; `table` is
// the host's scratch table, read by `read_scratch`).
template <bool kRadiance, bool kLight>
inline cudaError_t launch_bwd(
    const float* x, const float* dirs, const float* cot, const float* c_out,
    int out_cols, const float* c_g, int n, int np, const uint2* w_fwd,
    const float* b_sdf, const Plan& fwd, const uint2* w_t, const Plan& tp,
    const float* wsdf_col, const uint2* w_rad, const float* b_rad,
    const Plan& rad, const uint2* w_radt, const Plan& radt,
    const uint2* w_l, const float* b_l, const uint2* w_lt,
    const LightPlan& lp, int detach_light, int mx, int md, int lda, int ldd,
    int ldg, void* ws16, float* ws32, const long long* table, float* out,
    void* stream) {
  Scratch sc;
  const long long* rest =
      read_scratch(table, fwd.n, kRadiance ? rad.n : 0, kLight ? lp.n : 0,
                   np, ws16, ws32, sc);
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = bwd_smem_bytes(lda, ldd, fwd.n - 1, ldg, kLight);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_sweep_kernel<kRadiance, kLight>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bwd_sweep_kernel<kRadiance, kLight><<<np / kSweepRows, kThreads, smem, st>>>(
      x, dirs, cot, c_out, out_cols, c_g, n, w_fwd, b_sdf, fwd, w_t, tp,
      wsdf_col, w_rad, b_rad, rad, w_radt, radt, w_l, b_l, w_lt, lp,
      detach_light, mx, md, lda, ldd, ldg, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_wgrad(fwd, kRadiance ? &rad : nullptr,
                      kLight ? &lp : nullptr, sc, rest, ws32, out, st);
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

// The light net's plan from its rows and its transpose's (n 0: none).
inline LightPlan read_light_plan(const int* desc, const int* t_desc, int n) {
  LightPlan p{};
  p.n = n;
  for (int l = 0; l < n && l < kMaxLight; ++l)
    for (int f = 0; f < 8; ++f) {
      p.L[l][f] = desc[l * 8 + f];
      if (t_desc) p.T[l][f] = t_desc[l * 8 + f];
    }
  return p;
}

}  // namespace i2sdf
