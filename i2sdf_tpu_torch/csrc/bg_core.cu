// K8 bg_core_fwd: the NeRF++ background's pair of MLPs at a batch of points
// on the inverted sphere, (x4 (N, 4), dirs (N, 3)) -> (sigma (N, 1),
// rgb (N, 3)).
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/fused_bg.py:
// 209 get_bg_core_op` (pallas_call at :289, `_make_fwd_kernel` at
// :95-118), the background branch of the renderer
// (`i2sdf_tpu/models/renderer.py:405-444`).
//
// What bounds it on the H100: operations. At the background config
// (implicit 8 x 256 on PE(x4) with multires 10, a skip at layer 4,
// radiance 1 x 128 on [PE(view) 27 ; features 256]) a point costs ~0.5 M
// multiply-adds in bf16 and moves 40 bytes (x4 and dirs in, sigma and rgb
// out): ~25 k flops per byte, far above the card's ~295.
//
// Design: K1's, for both nets in one launch. A block of 64 points runs
// through every layer with its activations in shared memory (two bf16
// buffers); the encodings are computed in the kernel from the raw
// coordinates, the implicit one re-injected, scaled by 1/sqrt(2), at the
// skip; the implicit net's last layer writes the features into the
// radiance net's input buffer and sigma to shared memory, and PE(view) is
// written beside the features. Products run on the tensor cores through
// mma.sync with f32 accumulation, weights streamed from L2 in fragment
// order (`common.cuh`).
#include "bg_common.cuh"

namespace i2sdf {
namespace {

constexpr int kBgMT = 4;  // 4 m-tiles = 64 rows a block
constexpr int kBgRows = kBgMT * 16;
constexpr int kBgMaxNT = 5;  // up to 8 warps * 5 tiles * 8 = 320 columns

inline size_t bg_fwd_smem_bytes(int lda, int d_in) {
  return 2 * (size_t)kBgRows * lda * sizeof(__nv_bfloat16) +
         (size_t)kBgRows * (d_in + 3 + 1) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
bg_fwd_kernel(const float* __restrict__ x4, const float* __restrict__ dirs,
              int n, const uint2* __restrict__ wi,
              const float* __restrict__ bi, Plan pi,
              const uint2* __restrict__ wr, const float* __restrict__ br,
              Plan pr, int d_in, int fx, int fv, int F, int lda,
              float* __restrict__ sigma, float* __restrict__ rgb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* buf[2];
  buf[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  buf[1] = buf[0] + kBgRows * lda;
  float* xs = reinterpret_cast<float*>(buf[1] + kBgRows * lda);
  float* ds = xs + kBgRows * d_in;
  float* sg = ds + kBgRows * 3;

  const int row0 = blockIdx.x * kBgRows;
  load_points(xs, x4, d_in, kBgRows, row0, n);
  load_points(ds, dirs, 3, kBgRows, row0, n);
  __syncthreads();
  write_pe_d(buf[0], lda, kBgRows, xs, d_in, fx, 0, pi.L[0][kK], 1.f);
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < pi.n; ++l) {
    const int* L = pi.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe_d(buf[cur], lda, kBgRows, xs, d_in, fx, L[kCol], L[kK],
                 kInvSqrt2);
      __syncthreads();
    }
    const uint2* W = wi + L[kWOff];
    const float* b = bi + L[kBOff];
    if (l < pi.n - 1) {
      EpiSoftplus epi{buf[cur ^ 1], lda, b,
                      (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, nullptr, 0};
      mma_layer<kBgMT, kBgMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiFeatSdf epi{buf[cur ^ 1], lda, b, sg, F};
      mma_layer<kBgMT, kBgMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // the radiance input: [features | PE(view)]
  write_pe_d(buf[cur], lda, kBgRows, ds, 3, fv, F, pr.L[0][kK], 1.f);
  __syncthreads();
  for (int l = 0; l < pr.n; ++l) {
    const int* L = pr.L[l];
    const uint2* W = wr + L[kWOff];
    const float* b = br + L[kBOff];
    if (l < pr.n - 1) {
      EpiRelu epi{buf[cur ^ 1], lda, b};
      mma_layer<kBgMT, kBgMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiRgbOut epi{rgb, b, row0, n, L[kReal]};
      mma_layer<kBgMT, kBgMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int r = threadIdx.x; r < kBgRows; r += kThreads)
    if (row0 + r < n) sigma[row0 + r] = sg[r];
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_bg_core_fwd(const float* x4, const float* dirs, int n,
                                 const void* wi, const float* bi,
                                 const int* plan_i, int n_i, const void* wr,
                                 const float* br, const int* plan_r, int n_r,
                                 int d_in, int fx, int fv, int F, int lda,
                                 float* sigma, float* rgb, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_i < 1 || n_i > kMaxLayers || n_r < 1 || n_r > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  const Plan pi = read_plan(plan_i, n_i), pr = read_plan(plan_r, n_r);
  const size_t smem = bg_fwd_smem_bytes(lda, d_in);
  cudaError_t err = set_smem((const void*)bg_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kBgRows - 1) / kBgRows;
  bg_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x4, dirs, n, (const uint2*)wi, bi, pi, (const uint2*)wr, br, pr, d_in,
      fx, fv, F, lda, sigma, rgb);
  return (int)cudaGetLastError();
}
