// K7 conv_check: per-ray convergence flags of the error-bounded sampler,
// is the opacity error bound at beta0 at most eps.
//
// Replaces the TPU kernel `i2sdf_tpu/ops/pallas/sampler_round.py:355
// conv_check_pallas` (pallas_call at :375), the per-ray sampler's
// `conv_impl` (`i2sdf_tpu/models/sampler.py:447-462`).
//
// What bounds it on the H100: bytes. A ray reads 2 S floats and writes one
// byte, for ~25 flops and four exponentials a sample (d*, the Laplace
// density, two prefix sums, the bound): ~3 flops per byte, two orders
// below the card's balance point. At the per-ray training shape (1,600
// rays, S = 416) the bound is ~1.6 us and at the eval chunk's (12,000
// rays) ~12 us, so at the first a launch costs more than the work.
//
// Design: K2's beta0 evaluation alone (`sampler_round.cu`). One ray to a
// block of 128 threads (K2's group of warps, E = ceil(S / 128) samples a
// thread, at most 8); the ray's rows staged in shared memory as K2 stages
// them; `Sections::load` and `error_bound` (`ray_common.cuh`) give d* and
// the bound's max over the sections with K2's scans and reductions in
// K2's fixed order. So the flag equals K2's decision to keep beta0 for
// the ray, bit for bit, and each thread's chain is E samples (4 at
// S = 416), not a warp's 13. The TPU kernel's hi/lo-split bf16 triangular
// matmuls for the two exclusive prefix sums were a workaround for its
// matrix unit.
#include "ray_common.cuh"

namespace i2sdf {
namespace {

template <int MAXE>
__global__ void __launch_bounds__(kGroupThreads)
conv_check_kernel(const float* __restrict__ z, const float* __restrict__ sdf,
                  const float* __restrict__ beta0_p, float eps,
                  unsigned char* __restrict__ conv, int S) {
  extern __shared__ float sm[];
  __shared__ GroupScratch g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray = blockIdx.x;
  float* zs = sm;
  float* ss = zs + S;
  stage_ray(z, sdf, ray, S, zs, ss);
  __syncthreads();
  Sections<MAXE> q;
  q.load(zs, ss, tid, S);
  const float beta0 = *beta0_p;
  const float bound = error_bound(q, beta0, g, warp, lane);
  if (tid == 0) conv[ray] = bound <= eps ? 1 : 0;
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_conv_check(const float* z, const float* sdf,
                                const float* beta0, float eps,
                                unsigned char* conv, int R, int S,
                                void* stream) {
  using namespace i2sdf;
  if (R <= 0) return 0;
  if (S < 2 || S > kMaxSamples) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * S * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(E)                                                   \
  conv_check_kernel<E><<<R, kGroupThreads, smem, st>>>(z, sdf, beta0, \
                                                       eps, conv, S)
  I2SDF_BY_SAMPLES(S, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
