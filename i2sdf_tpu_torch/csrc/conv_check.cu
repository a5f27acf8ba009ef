// K7 conv_check: per-ray convergence flags of the error-bounded sampler,
// is the opacity error bound at beta0 at most eps.
//
// Replaces the TPU kernel `i2sdf_tpu/ops/pallas/sampler_round.py:355
// conv_check_pallas` (pallas_call at :375), the per-ray sampler's
// `conv_impl` (`i2sdf_tpu/models/sampler.py:447-462`).
//
// What bounds it on the H100: bytes. A ray reads 2 S floats and writes one
// byte, for ~25 flops a sample (d*, the Laplace density, two prefix sums,
// the bound): ~3 flops per byte, two orders below the card's balance
// point. At the per-ray training shapes (1600 rays, S up to 416) the bound
// is ~1.6 us, so a launch costs more than the work.
//
// Design: K2's first step alone. One warp per ray, 4 rays per block; the
// ray's rows are staged in shared memory, and `Ray::load` / `error_bound`
// (`ray_common.cuh`, shared with K2) give d* and the bound's max over the
// sections with f32 scans: the flag is exactly K2's own convergence test.
// The TPU kernel's hi/lo-split bf16 triangular matmuls for the two
// exclusive prefix sums were a workaround for its matrix unit.
#include "ray_common.cuh"

namespace i2sdf {
namespace {

template <int MAXE>
__global__ void __launch_bounds__(kRayWarps * 32)
conv_check_kernel(const float* __restrict__ z, const float* __restrict__ sdf,
                  const float* __restrict__ beta0_p, float eps,
                  unsigned char* __restrict__ conv, int R, int S) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kRayWarps + warp;
  if (ray >= R) return;  // whole warp; only warp-level sync below
  float* zs = sm + warp * 2 * S;
  float* ss = zs + S;
  for (int j = lane; j < S; j += 32) {
    zs[j] = z[(size_t)ray * S + j];
    ss[j] = sdf[(size_t)ray * S + j];
  }
  __syncwarp();
  Ray<MAXE> q;
  q.load(zs, ss, lane, S);
  const float bound = q.error_bound(*beta0_p);
  if (lane == 0) conv[ray] = bound <= eps ? 1 : 0;
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_conv_check(const float* z, const float* sdf,
                                const float* beta0, float eps,
                                unsigned char* conv, int R, int S,
                                void* stream) {
  using namespace i2sdf;
  if (R <= 0) return 0;
  if (S < 2 || S > 32 * 32) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kRayWarps - 1) / kRayWarps;
  const size_t smem = (size_t)kRayWarps * 2 * S * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 32 * 16) {
    conv_check_kernel<16><<<blocks, kRayWarps * 32, smem, st>>>(
        z, sdf, beta0, eps, conv, R, S);
  } else {
    conv_check_kernel<32><<<blocks, kRayWarps * 32, smem, st>>>(
        z, sdf, beta0, eps, conv, R, S);
  }
  return (int)cudaGetLastError();
}
