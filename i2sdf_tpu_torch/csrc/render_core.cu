// K3 render_core_fwd: SDF, its spatial gradient and the radiance at a batch
// of points along their view directions (the eval forward of the render).
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_train.py:449 get_render_core_op` (pallas_call at :555), reached
// through `render_core_fused` (`fused_train.py:707`), the eval forward at
// `i2sdf_tpu/models/renderer.py:321-334`.
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the SDF forward (~0.99 M flops with the 257-wide head), the
// reverse sweep (~0.93 M) and the radiance net (~0.54 M), ~2.5 M bf16
// flops, against 24 bytes in and 28 out.
//
// Design: a block of 32 points runs the SDF net forward with activations in
// shared memory, stashing each hidden layer's activation derivative
// (sigmoid(100 z), bf16, 8 x 32 x 264) for the reverse sweep. The output
// layer's columns are permuted host-side to [features | sdf], so the
// 256 features stay in shared memory and become, with PE(dirs) appended,
// the radiance net's input (ReLU hidden layers, sigmoid output). The
// reverse sweep then carries d sdf / d h back through the SDF net with the
// transposed weights (packed separately), adding the encoding's share at
// the skip layer, and the gradient with respect to x comes from the
// closed-form Jacobian of the wide-block encoding: d sin(f x)/dx =
// f cos(f x), d cos(f x)/dx = -f sin(f x). Only sdf, grad and rgb reach
// device memory.
#include "common.cuh"

namespace i2sdf {
namespace {

constexpr int kMT = 2;             // 2 m-tiles = 32 rows per block
constexpr int kRows = kMT * 16;
constexpr int kMaxNT = 5;          // up to 8 warps * 5 tiles * 8 = 320 cols

// Last SDF layer, columns [features (F) | sdf]: features to the radiance
// input buffer (no activation), sdf to shared memory.
struct EpiFeatSdf {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  float* sdf_s;
  int F;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float z0 = v0 + bias[c], z1 = v1 + bias[c + 1];
    if (c < F) {
      *reinterpret_cast<uint32_t*>(out + r * lda + c) = pack_bf16x2(z0, z1);
    } else if (c == F) {
      sdf_s[r] = z0;
    }
  }
};

struct EpiRelu {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(out + r * lda + c) = pack_bf16x2(
        fmaxf(v0 + bias[c], 0.f), fmaxf(v1 + bias[c + 1], 0.f));
  }
};

struct EpiRgb {
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
    *reinterpret_cast<uint32_t*>(out + r * lda + c) =
        pack_bf16x2(one(r, c, v0, d.x), one(r, c + 1, v1, d.y));
  }
};

struct Smem {
  __nv_bfloat16 *buf0, *buf1, *dact;
  float *xs, *ds, *sdf_s, *gpe;
};

__device__ __forceinline__ Smem carve(unsigned char* p, int lda, int ldd,
                                      int n_dact, int ldg) {
  Smem s;
  s.buf0 = reinterpret_cast<__nv_bfloat16*>(p);
  s.buf1 = s.buf0 + kRows * lda;
  s.dact = s.buf1 + kRows * lda;
  s.xs = reinterpret_cast<float*>(s.dact + (size_t)n_dact * kRows * ldd);
  s.ds = s.xs + kRows * 3;
  s.sdf_s = s.ds + kRows * 3;
  s.gpe = s.sdf_s + kRows;
  return s;
}

__global__ void __launch_bounds__(kThreads)
render_core_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                   int n, const uint2* __restrict__ w_fwd,
                   const float* __restrict__ b_sdf, Plan fwd,
                   const uint2* __restrict__ w_rev, Plan rev,
                   const float* __restrict__ wsdf_col,
                   const uint2* __restrict__ w_rad,
                   const float* __restrict__ b_rad, Plan rad, int mx, int md,
                   int lda, int ldd, int ldg, float* __restrict__ sdf_out,
                   float* __restrict__ grad_out, float* __restrict__ rgb_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_hidden = fwd.n - 1;
  const Smem s = carve(smem, lda, ldd, n_hidden, ldg);
  __nv_bfloat16* buf[2] = {s.buf0, s.buf1};
  const int row0 = blockIdx.x * kRows;
  const int d0x = 3 + 6 * mx;
  const int F = fwd.L[fwd.n - 1][kReal] - 1;  // feature width

  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = row0 + i / 3;
    s.xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
    s.ds[i] = r < n ? dirs[(size_t)r * 3 + i % 3] : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * ldg; i += kThreads) s.gpe[i] = 0.f;
  __syncthreads();
  write_pe(buf[0], lda, kRows, s.xs, mx, 0, fwd.L[0][kK], 1.f);
  __syncthreads();

  // ---- SDF forward, stashing activation derivatives --------------------
  int cur = 0;
  for (int l = 0; l < fwd.n; ++l) {
    const int* L = fwd.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe(buf[cur], lda, kRows, s.xs, mx, L[kCol], L[kK], kInvSqrt2);
      __syncthreads();
    }
    const uint2* W = w_fwd + L[kWOff];
    const float* b = b_sdf + L[kBOff];
    if (l < n_hidden) {
      EpiSoftplus epi{buf[cur ^ 1], lda, b,
                      (L[kFlags] & kScale) ? kInvSqrt2 : 1.f,
                      s.dact + (size_t)l * kRows * ldd, ldd};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiFeatSdf epi{buf[cur ^ 1], lda, b, s.sdf_s, F};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- radiance net on [features | PE(dirs)] ----------------------------
  write_pe(buf[cur], lda, kRows, s.ds, md, F, rad.L[0][kK], 1.f);
  __syncthreads();
  for (int l = 0; l < rad.n; ++l) {
    const int* L = rad.L[l];
    const uint2* W = w_rad + L[kWOff];
    const float* b = b_rad + L[kBOff];
    if (l < rad.n - 1) {
      EpiRelu epi{buf[cur ^ 1], lda, b};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiRgb epi{rgb_out, b, row0, n, L[kReal]};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- reverse sweep: d sdf / d x --------------------------------------
  // through the output layer: r = W_last[:, sdf] * dact_last-hidden
  // (wsdf_col is zero-padded to the next layer's depth K)
  {
    const int K = rev.L[0][kK];
    const __nv_bfloat16* dl = s.dact + (size_t)(n_hidden - 1) * kRows * ldd;
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K, c = i % K;
      buf[cur][r * lda + c] = __float2bfloat16_rn(
          wsdf_col[c] * __bfloat162float(dl[r * ldd + c]));
    }
  }
  __syncthreads();
  // rev.L[i] is the transpose of hidden layer n_hidden - 1 - i
  for (int i = 0; i < rev.n; ++i) {
    const int* L = rev.L[i];
    const int l = n_hidden - 1 - i;
    EpiRev epi{buf[cur ^ 1], lda,
               l > 0 ? s.dact + (size_t)(l - 1) * kRows * ldd : nullptr, ldd,
               (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, L[kReal], L[kCol],
               d0x, s.gpe, ldg};
    mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], w_rev + L[kWOff], L[kN],
                           epi);
    __syncthreads();
    cur ^= 1;
  }

  // ---- encoding Jacobian, outputs --------------------------------------
  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = i / 3, d = i % 3;
    if (row0 + r >= n) continue;
    const float* gp = s.gpe + r * ldg;
    const float xd = s.xs[3 * r + d];
    float g = gp[d];
    for (int j = 0; j < mx; ++j) {
      const float f = ldexpf(1.f, j);
      g += f * (gp[3 + d * mx + j] * cosf(xd * f)
                - gp[3 + 3 * mx + d * mx + j] * sinf(xd * f));
    }
    grad_out[(size_t)(row0 + r) * 3 + d] = g;
    if (d == 0) sdf_out[row0 + r] = s.sdf_s[r];
  }
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_render_core_fwd(
    const float* x, const float* dirs, int n, const void* w_fwd,
    const float* b_sdf, const int* fwd_desc, int n_fwd, const void* w_rev,
    const int* rev_desc, int n_rev, const float* wsdf_col, const void* w_rad,
    const float* b_rad, const int* rad_desc, int n_rad, int mx, int md,
    int lda, int ldd, int ldg, float* sdf_out, float* grad_out,
    float* rgb_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  const Plan fwd = read_plan(fwd_desc, n_fwd);
  const Plan rev = read_plan(rev_desc, n_rev);
  const Plan rad = read_plan(rad_desc, n_rad);
  const size_t smem = (2 * (size_t)kRows * lda +
                       (size_t)(n_fwd - 1) * kRows * ldd) *
                          sizeof(__nv_bfloat16) +
                      (size_t)kRows * (3 + 3 + 1 + ldg) * sizeof(float);
  cudaError_t err = set_smem((const void*)render_core_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  render_core_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, dirs, n, (const uint2*)w_fwd, b_sdf, fwd, (const uint2*)w_rev, rev,
      wsdf_col, (const uint2*)w_rad, b_rad, rad, mx, md, lda, ldd, ldg,
      sdf_out, grad_out, rgb_out);
  return (int)cudaGetLastError();
}
