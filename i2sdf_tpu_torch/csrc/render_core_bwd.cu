// K4 render_core_bwd: the backward of the render core (SDF, its spatial
// gradient and the radiance at a batch of points): the gradients of
// <cot, [grad | sdf | rgb]> with respect to every weight and bias of the
// SDF net and the radiance net, second-order terms included.
//
// Replaces the backward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_train.py:449 get_render_core_op` (pallas_call at :609, body
// `_make_bwd_kernel` at :267-446), reached through the custom-VJP render
// core of the training step (`i2sdf_tpu/models/renderer.py:345-377`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the forward recompute (SDF with the 257-wide head and the
// radiance net), the reverse sweep, the radiance backward, the upward
// and downward sweeps through the SDF net, and its share of the 14
// weight-gradient products, ~7.6 M bf16 flops at the nets' real widths
// (`chip_smoke.py::k4_macs`), against 52 bytes in.
//
// Design. The TPU kernel sums each weight gradient over its sequential
// grid in VMEM; the ~3.2 MB of f32 weight gradients do not fit in an
// SM's 227 KB, and the card's blocks run in parallel. So the work is
// split in three launches:
//
// 1. `sweep_kernel`, 32 points a block, one block per SM (shared memory
//    as K3's: two activation buffers and every hidden layer's activation
//    derivative). It recomputes the forward, runs the radiance backward,
//    the reverse sweep (d sdf / d h), the upward sweep (the transpose of
//    the reverse sweep, which yields the second-order term dz_extra =
//    dr * ah * 100 s (1 - s)) and the downward sweep, each layer a tiled
//    mma.sync product as in K3. For every layer it writes the two bf16
//    operands of that layer's weight gradient to device memory: for an
//    SDF layer dW = da^T r + X^T dz = [da ; X]^T [r ; dz], one product
//    over the two stacked along the points; for a radiance layer
//    X^T dz. The bias gradients are summed over the block's rows in f32,
//    each column by one thread in row order, into one row per block.
// 2. `atb_kernel`: every A^T B over the points, 64 x 64 output tiles,
//    each block one tile over one range of points (split K), mma.sync on
//    fragments gathered from shared memory; the partial sums go to
//    device memory.
// 3. `sum_kernel`: the point ranges' partial sums, and the blocks' bias
//    rows, added in a fixed order, so the result does not change from
//    run to run.
//
// The activation derivative is stashed as q = sigmoid(-|100 z|) with the
// sign bit set where z > 0 (and -0 in softplus's linear region), so both
// s = sigmoid(100 z) and 1 - s keep bf16's relative precision in the
// second-order factor 100 s (1 - s). The encoding's Jacobian is the
// closed form (d sin(f x)/dx = f cos(f x)). Eikonal rows carry zero
// directions and zero rgb and sdf cotangents, so only c_grad reaches them.
#include <algorithm>

#include "common.cuh"

namespace i2sdf {
namespace {

constexpr int kMT = 2;
constexpr int kRows = kMT * 16;
constexpr int kMaxNT = 5;
constexpr int kMaxSdf = 12;
constexpr int kMaxRad = 8;
constexpr int kMaxJobs = kMaxSdf + kMaxRad;
constexpr int kCot = 8;  // shared-memory stride of a row's cotangents

struct Scratch {
  __nv_bfloat16* ax[kMaxSdf];   // (2 np, K_l): [da_l ; X_l]
  __nv_bfloat16* br[kMaxSdf];   // (2 np, N_l): [r_l ; dz_l]
  __nv_bfloat16* dzx[kMaxSdf];  // (np, N_l): dz_extra into z_l
  float* ah[kMaxSdf];           // (np, K_l): d sdf / d h_l
  __nv_bfloat16* rx[kMaxRad];   // (np, K_L): radiance layer inputs
  __nv_bfloat16* rdz[kMaxRad];  // (np, N_L): radiance output cotangents
  float* dbpart;                // (blocks, tb): bias-gradient rows
  int tb, np;
  int db_sdf[kMaxSdf];
  int db_rad[kMaxRad];
};

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

__device__ __forceinline__ float bf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

// Copy `cols` (a multiple of 8) columns of the block's rows between shared
// memory (row stride lda) and device memory (row stride ld), 16 bytes a
// thread.
__device__ void store_rows(const __nv_bfloat16* s, int lda,
                           __nv_bfloat16* g, int ld, int cols, int row0) {
  const int v = cols >> 3;
  for (int i = threadIdx.x; i < kRows * v; i += kThreads) {
    const int r = i / v, c = (i % v) << 3;
    *reinterpret_cast<uint4*>(g + (size_t)(row0 + r) * ld + c) =
        *reinterpret_cast<const uint4*>(s + r * lda + c);
  }
}

__device__ void load_rows(__nv_bfloat16* s, int lda, const __nv_bfloat16* g,
                          int ld, int cols, int row0) {
  const int v = cols >> 3;
  for (int i = threadIdx.x; i < kRows * v; i += kThreads) {
    const int r = i / v, c = (i % v) << 3;
    *reinterpret_cast<uint4*>(s + r * lda + c) =
        *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * ld + c);
  }
}

// Hidden SDF layer of the recompute: bf16(scale * softplus100(acc + b)),
// and the stash q of its derivative.
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

// Last SDF layer, columns [features | sdf]: the features become the
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

struct EpiRelu {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    put2(out + r * lda + c, fmaxf(v0 + bias[c], 0.f),
         fmaxf(v1 + bias[c + 1], 0.f));
  }
};

struct EpiRgb {
  float* rgb;  // kRows x 4, shared
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
  float* dzf;  // kRows x lda f32, shared: the values the bias sums take
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

struct Smem4 {
  __nv_bfloat16 *buf0, *buf1, *q;
  float *xs, *ds, *cot, *rgb, *dge, *dzf;
};

__device__ __forceinline__ Smem4 carve4(unsigned char* p, int lda, int ldd,
                                        int n_q, int ldg) {
  Smem4 s;
  s.buf0 = reinterpret_cast<__nv_bfloat16*>(p);
  s.buf1 = s.buf0 + kRows * lda;
  s.q = s.buf1 + kRows * lda;
  s.xs = reinterpret_cast<float*>(s.q + (size_t)n_q * kRows * ldd);
  s.ds = s.xs + kRows * 3;
  s.cot = s.ds + kRows * 3;
  s.rgb = s.cot + kRows * kCot;
  s.dge = s.rgb + kRows * 4;
  s.dzf = s.dge + kRows * ldg;
  return s;
}

// The block's bias-gradient row: column c summed over the rows in order.
__device__ __forceinline__ void put_db(float* dst, const float* dzf, int lda,
                                       int n) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < kRows; ++r) acc += dzf[r * lda + c];
    dst[c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
             const float* __restrict__ cot, int n,
             const uint2* __restrict__ w_fwd, const float* __restrict__ b_sdf,
             Plan fwd, const uint2* __restrict__ w_t, Plan tp,
             const float* __restrict__ wsdf_col,
             const uint2* __restrict__ w_rad, const float* __restrict__ b_rad,
             Plan rad, const uint2* __restrict__ w_radt, Plan radt, int mx,
             int md, int lda, int ldd, int ldg, Scratch sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = fwd.n, nh = ns - 1, nr = rad.n;
  const Smem4 s = carve4(smem, lda, ldd, nh, ldg);
  __nv_bfloat16* buf[2] = {s.buf0, s.buf1};
  const int row0 = blockIdx.x * kRows;
  const int np = sc.np;
  const int d0 = 3 + 6 * mx;
  const int F = fwd.L[ns - 1][kReal] - 1;
  float* dbp = sc.dbpart + (size_t)blockIdx.x * sc.tb;

  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = row0 + i / 3;
    s.xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
    s.ds[i] = r < n ? dirs[(size_t)r * 3 + i % 3] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * kCot; i += kThreads) {
    const int r = row0 + i / kCot, c = i % kCot;
    s.cot[i] = (r < n && c < 7) ? cot[(size_t)r * 7 + c] : 0.f;
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
    } else {
      EpiFeat epi{buf[cur ^ 1], lda, b, F};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- 2. radiance forward: X_L to rx[L], rgb to shared memory ----------
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
      EpiRgb epi{s.rgb, b, L[kReal]};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- 3. radiance backward ---------------------------------------------
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
  const int n_last = fwd.L[ns - 1][kN];
  __nv_bfloat16* cy = sc.br[ns - 1] + (size_t)np * n_last;
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
      put_db(dbp + sc.db_sdf[ns - 1], s.dzf, lda, n_last);
      __syncthreads();
    }
  }

  // ---- 4. reverse sweep: r_l to br[l] rows [0, np), ah_l to ah[l] -------
  {
    for (int i = threadIdx.x; i < kRows * n_last; i += kThreads) {
      const int r = i / n_last, c = i % n_last;
      sc.br[ns - 1][(size_t)(row0 + r) * n_last + c] =
          __float2bfloat16_rn(c == F ? 1.f : 0.f);
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

}  // namespace
}  // namespace i2sdf

// The scratch table (int64, element offsets) is built by
// `i2sdf_tpu_torch/ops/kernels/render_core.py::_BwdPlan` and read here in
// the same order.
extern "C" int i2sdf_render_core_bwd(
    const float* x, const float* dirs, const float* cot, int n, int np,
    const void* w_fwd, const float* b_sdf, const int* fwd_desc, int n_fwd,
    const void* w_t, const int* t_desc, int n_t, const float* wsdf_col,
    const void* w_rad, const float* b_rad, const int* rad_desc, int n_rad,
    const void* w_radt, const int* radt_desc, int n_radt, int mx, int md,
    int lda, int ldd, int ldg, void* ws16, float* ws32,
    const long long* table, float* out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxSdf || n_rad > kMaxRad || n_t != n_fwd ||
      n_radt != n_rad || n_fwd < 2)
    return (int)cudaErrorInvalidValue;
  const Plan fwd = read_plan(fwd_desc, n_fwd);
  const Plan tp = read_plan(t_desc, n_t);
  const Plan rad = read_plan(rad_desc, n_rad);
  const Plan radt = read_plan(radt_desc, n_radt);
  __nv_bfloat16* b16 = (__nv_bfloat16*)ws16;
  const long long* t = table;
  Scratch sc;
  for (int l = 0; l < n_fwd; ++l) sc.ax[l] = b16 + *t++;
  for (int l = 0; l < n_fwd; ++l) sc.br[l] = b16 + *t++;
  for (int l = 0; l < n_fwd; ++l, ++t) sc.dzx[l] = *t < 0 ? nullptr : b16 + *t;
  for (int l = 0; l < n_fwd; ++l, ++t) sc.ah[l] = *t < 0 ? nullptr : ws32 + *t;
  for (int l = 0; l < n_rad; ++l) sc.rx[l] = b16 + *t++;
  for (int l = 0; l < n_rad; ++l) sc.rdz[l] = b16 + *t++;
  sc.dbpart = ws32 + *t++;
  sc.tb = (int)*t++;
  sc.np = np;
  for (int l = 0; l < n_fwd; ++l) sc.db_sdf[l] = (int)*t++;
  for (int l = 0; l < n_rad; ++l) sc.db_rad[l] = (int)*t++;
  const int jobs_n = n_fwd + n_rad;
  const long long* splits = t;
  const long long* chunk = t + jobs_n;
  const long long* part = t + 2 * jobs_n;
  const long long* outp = t + 3 * jobs_n;
  const long long out_db = t[4 * jobs_n];
  const int blocks = np / kRows;
  const cudaStream_t st = (cudaStream_t)stream;

  const size_t smem =
      (2 * (size_t)kRows * lda + (size_t)(n_fwd - 1) * kRows * ldd) *
          sizeof(__nv_bfloat16) +
      (size_t)kRows * (3 + 3 + kCot + 4 + ldg + lda) * sizeof(float);
  cudaError_t err = set_smem((const void*)sweep_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<<<blocks, kThreads, smem, st>>>(
      x, dirs, cot, n, (const uint2*)w_fwd, b_sdf, fwd, (const uint2*)w_t,
      tp, wsdf_col, (const uint2*)w_rad, b_rad, rad, (const uint2*)w_radt,
      radt, mx, md, lda, ldd, ldg, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  GemmJobs gj;
  SumJobs sj;
  gj.n = jobs_n;
  sj.n = jobs_n + 1;
  int gemm_blocks = 0;
  long long total = 0;
  for (int p = 0; p < jobs_n; ++p) {
    const bool is_sdf = p < n_fwd;
    const int* L = is_sdf ? fwd.L[p] : rad.L[p - n_fwd];
    GemmJob& J = gj.j[p];
    J.a = is_sdf ? sc.ax[p] : sc.rx[p - n_fwd];
    J.b = is_sdf ? sc.br[p] : sc.rdz[p - n_fwd];
    J.part = ws32 + part[p];
    J.m = is_sdf ? 2 * np : np;
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
  sj.j[jobs_n] = SumJob{sc.dbpart, out + out_db, (long long)sc.tb, blocks};
  sj.total = total + sc.tb;
  atb_kernel<<<gemm_blocks, kThreads, 0, st>>>(gj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int sum_blocks = (int)std::min<long long>(
      (sj.total + kThreads - 1) / kThreads, 4096);
  sum_kernel<<<sum_blocks, kThreads, 0, st>>>(sj);
  return (int)cudaGetLastError();
}
