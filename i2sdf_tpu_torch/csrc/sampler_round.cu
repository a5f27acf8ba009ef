// K2 sampler_round: one refinement round of the error-bounded sampler
// (VolSDF Algorithm 1) for a batch of rays.
//
// Replaces the TPU kernel `i2sdf_tpu/ops/pallas/sampler_round.py:218
// sampler_round_pallas` (pallas_call at :249), the sampler's `round_impl`
// (`i2sdf_tpu/models/sampler.py:432-446`, final round `:407-418`).
//
// What bounds it on the H100: bytes, by a wide margin at these shapes. A
// ray reads 2*S + n_out + 1 floats and writes n_out + 1 (at S = 480,
// n_out = 64: ~4.5 KB) and computes ~12 passes of a few transcendentals
// over its S samples. The work per byte is ~15 flops, far below the
// ~295 flops per byte at which the card's compute would become the limit;
// what a simple kernel loses instead is latency: the bisection is 10
// dependent steps of two scans and a max each.
//
// Design: one warp per ray, 4 rays per block. The ray's z and sdf rows are
// staged in shared memory (coalesced); each lane then owns E = ceil(S/32)
// consecutive samples in registers. Every prefix sum is a sequential sum
// within the lane plus a warp scan of the lane totals, in f32; the TPU
// kernel's hi/lo-split bf16 triangular matmuls were a workaround for its
// matrix unit and are not carried over. The CDF's lane offsets are summed
// in one fixed order on every lane, so the CDF is exactly nondecreasing and
// the inverse-CDF bracket is a binary search over it in shared memory.
#include "ray_common.cuh"

namespace i2sdf {
namespace {

template <int MAXE>
__global__ void __launch_bounds__(kRayWarps * 32)
sampler_round_kernel(const float* __restrict__ z, const float* __restrict__ sdf,
                     const float* __restrict__ beta_in,
                     const float* __restrict__ u, float* __restrict__ samples,
                     float* __restrict__ beta_out, int R, int S, int n_out,
                     const float* __restrict__ beta0_p, int beta_iters,
                     float eps, float add_tiny, int is_final) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kRayWarps + warp;
  if (ray >= R) return;  // whole warp; only warp-level sync below
  float* zs = sm + warp * 3 * S;
  float* ss = zs + S;
  float* cs = ss + S;
  for (int j = lane; j < S; j += 32) {
    zs[j] = z[(size_t)ray * S + j];
    ss[j] = sdf[(size_t)ray * S + j];
  }
  __syncwarp();

  Ray<MAXE> q;
  q.load(zs, ss, lane, S);

  // ---- beta: converged rays take beta0, the rest bisect ------------------
  const float beta0 = *beta0_p;
  float beta = beta_in[ray];
  if (q.error_bound(beta0) <= eps) beta = beta0;
  float lo = beta0, hi = beta;
  for (int it = 0; it < beta_iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (q.error_bound(mid) <= eps) hi = mid; else lo = mid;
  }
  beta = hi;

  // ---- weights, pdf ---------------------------------------------------
  float pdf[MAXE], fe_ex[MAXE], r_in[MAXE];
  float ft = 0.f, rt = 0.f;
  const float inv4b2 = 1.f / (4.f * beta * beta);
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    fe_ex[k] = ft;
    pdf[k] = 0.f;
    if (q.smp(k)) {
      const float fe = (q.sec(k) ? q.d[k] : 1e10f) * laplace(q.s[k], beta);
      pdf[k] = fe;  // free energy, until the pass below
      ft += fe;
      if (q.sec(k)) rt += expf(-q.ds[k] / beta) * q.d[k] * q.d[k] * inv4b2;
    }
    r_in[k] = rt;
  }
  const float fo = warp_excl_scan(ft, lane);
  const float ro = is_final ? 0.f : warp_excl_scan(rt, lane);
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    float p = 0.f;
    if (q.sec(k)) {
      const float trans = expf(-(fo + fe_ex[k]));
      p = is_final ? (1.f - expf(-pdf[k])) * trans + 1e-5f
                : (fminf(expf(ro + r_in[k]), 1e6f) - 1.f) * trans + add_tiny;
    }
    pdf[k] = p;
    tot += p;
  }
  const float total = warp_sum(tot);

  // ---- CDF (exactly nondecreasing), inverse-CDF draws ------------------
  float lt = 0.f;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    if (q.sec(k)) {
      pdf[k] = total > 0.f ? pdf[k] / fmaxf(total, 1e-30f)
                           : 1.f / (float)(S - 1);
      lt += pdf[k];
      pdf[k] = lt;  // lane-local inclusive sum
    }
  }
  float off = 0.f;
  for (int src = 0; src < 31; ++src) {
    const float t = __shfl_sync(kFull, lt, src);
    if (lane > src) off += t;
  }
  if (lane == 0) cs[0] = 0.f;
#pragma unroll
  for (int k = 0; k < MAXE; ++k)
    if (q.sec(k)) cs[q.base + k + 1] = off + pdf[k];
  __syncwarp();

  for (int i = lane; i < n_out; i += 32) {
    const float uq = u[(size_t)ray * n_out + i];
    int a = 0, b = S;  // count of cdf entries <= uq
    while (a < b) {
      const int m = (a + b) >> 1;
      if (cs[m] <= uq) a = m + 1; else b = m;
    }
    const int below = max(a - 1, 0), above = min(a, S - 1);
    float denom = cs[above] - cs[below];
    if (denom < 1e-5f) denom = 1.f;
    const float t = (uq - cs[below]) / denom;
    samples[(size_t)ray * n_out + i] = zs[below] + t * (zs[above] - zs[below]);
  }
  if (lane == 0) beta_out[ray] = beta;
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_sampler_round(const float* z, const float* sdf,
                                   const float* beta_in, const float* u,
                                   float* samples, float* beta_out, int R,
                                   int S, int n_out, const float* beta0,
                                   int beta_iters, float eps, float add_tiny,
                                   int is_final, void* stream) {
  using namespace i2sdf;
  if (R <= 0) return 0;
  if (S < 2 || S > 32 * 32) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kRayWarps - 1) / kRayWarps;
  const size_t smem = (size_t)kRayWarps * 3 * S * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 32 * 16) {
    sampler_round_kernel<16><<<blocks, kRayWarps * 32, smem, st>>>(
        z, sdf, beta_in, u, samples, beta_out, R, S, n_out, beta0,
        beta_iters, eps, add_tiny, is_final);
  } else {
    sampler_round_kernel<32><<<blocks, kRayWarps * 32, smem, st>>>(
        z, sdf, beta_in, u, samples, beta_out, R, S, n_out, beta0,
        beta_iters, eps, add_tiny, is_final);
  }
  return (int)cudaGetLastError();
}
