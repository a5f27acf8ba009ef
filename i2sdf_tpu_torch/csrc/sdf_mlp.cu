// K1 sdf_mlp_nograd: no-grad SDF of the implicit MLP at a batch of points.
//
// Replaces the TPU kernel `i2sdf_tpu/ops/pallas/fused_mlp.py:157
// fused_sdf_mlp` (pallas_call at :225), the error-bound sampler's SDF
// evaluator (`i2sdf_tpu/models/renderer.py:263-271`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs 2 * (48*256 + 6*256*256 + 256*224 + 256*16) ~= 0.93 M bf16 flops
// (padded widths) and moves 16 bytes (xyz in, sdf out), ~58 k per byte,
// far above the card's ~295 flops per byte balance point.
//
// Design: a block of 64 points runs through every layer with its
// activations in shared memory (2 x 64 x 264 bf16), so no hidden layer
// reaches device memory. The positional encoding is computed in the kernel
// from the raw points (reading 12 bytes a point instead of a 39-wide
// encoding) and re-injected, scaled by 1/sqrt(2), at the skip layer. The
// output layer is cut to the sdf column (16 padded columns). Products run
// on the tensor cores through mma.sync with f32 accumulation; wgmma and
// TMA are later work.
#include "common.cuh"

namespace i2sdf {
namespace {

constexpr int kMT = 4;             // 4 m-tiles = 64 rows per block
constexpr int kRows = kMT * 16;
constexpr int kMaxNT = 4;          // up to 8 warps * 4 tiles * 8 = 256 cols

struct EpiSdfOut {
  float* out;
  const float* bias;
  int row0, n;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float) {
    if (c == 0 && row0 + r < n) out[row0 + r] = v0 + bias[0];
  }
};

__global__ void __launch_bounds__(kThreads)
sdf_mlp_kernel(const float* __restrict__ pts, float* __restrict__ sdf, int n,
               const uint2* __restrict__ wblob,
               const float* __restrict__ bblob, Plan plan, int multires,
               int lda) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* buf[2];
  buf[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  buf[1] = buf[0] + kRows * lda;
  float* xs = reinterpret_cast<float*>(buf[1] + kRows * lda);

  const int row0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < n ? pts[(size_t)r * 3 + i % 3] : 0.f;
  }
  __syncthreads();
  write_pe(buf[0], lda, kRows, xs, multires, 0, plan.L[0][kK], 1.f);
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < plan.n; ++l) {
    const int* L = plan.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe(buf[cur], lda, kRows, xs, multires, L[kCol], L[kK], kInvSqrt2);
      __syncthreads();
    }
    const uint2* W = wblob + L[kWOff];
    const float* b = bblob + L[kBOff];
    if (l < plan.n - 1) {
      EpiSoftplus epi{buf[cur ^ 1], lda, b,
                      (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, nullptr, 0};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiSdfOut epi{sdf, b, row0, n};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_sdf_mlp_nograd(const float* pts, float* sdf, int n,
                                    const void* wblob, const float* bblob,
                                    const int* plan_desc, int n_layers,
                                    int multires, int lda, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  const Plan plan = read_plan(plan_desc, n_layers);
  const size_t smem = 2 * kRows * lda * sizeof(__nv_bfloat16) +
                      kRows * 3 * sizeof(float);
  cudaError_t err = set_smem((const void*)sdf_mlp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  sdf_mlp_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      pts, sdf, n, (const uint2*)wblob, bblob, plan, multires, lda);
  return (int)cudaGetLastError();
}

extern "C" const char* i2sdf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
