// K5 rev_fwd: the SDF net's outputs and the spatial gradient of its sdf at
// a batch of points: out = [sdf | features] (N, 1 + F) and grad (N, 3),
// both f32.
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_rev.py:213 get_rev_op` (pallas_call at :244, body
// `_make_fwd_kernel` at :115-135), reached through
// `sdf_outputs_fused_rev` (`fused_rev.py:329`): on the training step with
// the normal losses off it gives `grad_theta` of the eikonal points
// (`i2sdf_tpu/models/renderer.py:473-477`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the SDF forward with the 257-wide head and the reverse sweep
// through the hidden layers, ~2.0 M bf16 flops at the net's real widths
// (`chip_smoke.py::k5_macs`), against 12 bytes in and 1,040 out, ~1.9 k
// flops a byte, far above the card's ~295 balance point.
//
// Design (`fwd_sweep_kernel` below): a block of 32 points runs
// the SDF net forward with its activations in shared memory, stashing each
// hidden layer's activation derivative (bf16) for the reverse sweep; the
// output layer writes its 257 columns straight to device memory in the
// net's own order (the kernel's weights keep it, so nothing is permuted);
// the reverse sweep carries d sdf / d h back through the transposed hidden
// layers, the encoding's share gathered at layer 0 and at the skip, and
// the closed-form Jacobian of the encoding gives d sdf / d x. mma.sync
// bf16 tiles with f32 accumulation.
#include "common.cuh"

namespace i2sdf {
namespace {

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

// Shared memory of `fwd_sweep_kernel` (bytes): two activation buffers,
// every hidden layer's activation derivative, and per row the point and
// the encoding's gradient.
inline size_t fwd_smem_bytes(int lda, int ldd, int n_dact, int ldg) {
  return (2 * (size_t)kSweepRows * lda +
          (size_t)n_dact * kSweepRows * ldd) *
             sizeof(__nv_bfloat16) +
         (size_t)kSweepRows * (3 + ldg) * sizeof(float);
}

// K5's kernel body. A block of 32 points runs the SDF net forward with its
// activations in shared memory, stashing each hidden layer's activation
// derivative (bf16 s = softplus100'(z)); the output layer writes its
// columns to device memory. Then d sdf / d h goes back through the
// transposed hidden layers (`rev`, rev.L[i] is hidden layer
// n_hidden-1-i), starting from r = W_last[:, sdf] * dact (`wsdf_col`, zero
// padded to the next layer's depth), the encoding's share gathered at
// layer 0 and at the skip into gpe (f32), and the closed-form Jacobian of
// the wide-block encoding, d sin(f x)/dx = f cos(f x), d cos(f x)/dx =
// -f sin(f x), gives d sdf / d x. The sweeps are written out in one kernel
// body (an indexed pair of buffers, restrict-qualified kernel arguments):
// as device functions, or with the buffers selected instead of indexed,
// the sweep ran measurably slower on the H100.
__global__ void __launch_bounds__(kThreads)
fwd_sweep_kernel(const float* __restrict__ x, int n,
                 const uint2* __restrict__ w_fwd,
                 const float* __restrict__ b_sdf, Plan fwd,
                 const uint2* __restrict__ w_rev, Plan rev,
                 const float* __restrict__ wsdf_col, int mx, int lda, int ldd,
                 int ldg, int out_cols, float* __restrict__ grad_out,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_hidden = fwd.n - 1;
  __nv_bfloat16* buf[2];
  buf[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  buf[1] = buf[0] + kSweepRows * lda;
  __nv_bfloat16* dact = buf[1] + kSweepRows * lda;
  float* xs = reinterpret_cast<float*>(dact + (size_t)n_hidden * kSweepRows *
                                                  ldd);
  float* gpe = xs + kSweepRows * 3;
  const int row0 = blockIdx.x * kSweepRows;
  const int d0x = 3 + 6 * mx;

  for (int i = threadIdx.x; i < kSweepRows * 3; i += kThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
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
    } else {
      EpiOut epi{out, b, row0, n, out_cols};
      mma_layer<kSweepMT, kSweepMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
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
  }
}

// Launch `fwd_sweep_kernel` on n points (the arguments as the kernel's);
// returns the launch's error.
inline cudaError_t launch_fwd_sweep(const float* x, int n, const uint2* w_fwd,
                                    const float* b_sdf, const Plan& fwd,
                                    const uint2* w_rev, const Plan& rev,
                                    const float* wsdf_col, int mx, int lda,
                                    int ldd, int ldg, int out_cols,
                                    float* grad_out, float* out,
                                    void* stream) {
  const size_t smem = fwd_smem_bytes(lda, ldd, fwd.n - 1, ldg);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kSweepRows - 1) / kSweepRows;
  fwd_sweep_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, n, w_fwd, b_sdf, fwd, w_rev, rev, wsdf_col, mx, lda, ldd, ldg,
      out_cols, grad_out, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_rev_fwd(const float* x, int n, const void* w_fwd,
                             const float* b_sdf, const int* fwd_desc,
                             int n_fwd, const void* w_rev,
                             const int* rev_desc, int n_rev,
                             const float* wsdf_col, int mx, int lda, int ldd,
                             int ldg, int out_cols, float* out,
                             float* grad_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxLayers || n_rev != n_fwd - 1 || n_fwd < 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch_fwd_sweep(
      x, n, (const uint2*)w_fwd, b_sdf, read_plan(fwd_desc, n_fwd),
      (const uint2*)w_rev, read_plan(rev_desc, n_rev), wsdf_col, mx, lda, ldd,
      ldg, out_cols, grad_out, out, stream);
}
