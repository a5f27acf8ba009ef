// K2 sampler_round: one refinement round of the error-bounded sampler
// (VolSDF Algorithm 1) for a batch of rays.
//
// Replaces the TPU kernel `i2sdf_tpu/ops/pallas/sampler_round.py:218
// sampler_round_pallas` (pallas_call at :249), the sampler's `round_impl`
// (`i2sdf_tpu/models/sampler.py:432-446`, final round `:407-418`).
//
// What bounds it on the H100: operations, on the special-function units. A
// ray reads 2*S + n_out + 1 floats and writes n_out + 1 (at S = 480,
// n_out = 64: ~4.5 KB), and evaluates the error bound beta_iters + 1 times
// (the beta0 check and the bisection) plus the pdf pass, each over its S
// samples: four exponentials a sample-evaluation (the Laplace density's
// expm1f, the d* term's expf and the bound's two expf), ~22 other f32
// operations. The exponentials run on the SFU at 16 a clock an SM, so they
// bound the kernel before its FMAs and its bytes do (`chip_smoke.py`
// counts both). What a simple kernel loses is latency instead: the
// bisection is 11 dependent evaluations, each a scan and a max over the
// ray.
//
// Design: a group of kGroupWarps warps (128 threads, one block) per ray, so
// each thread owns E = ceil(S / 128) <= 8 consecutive samples in registers
// (4 at S = 480, where one warp a ray held 15): a short chain a thread,
// small per-thread arrays, and many resident blocks. The ray's z and sdf
// rows are staged in shared memory (coalesced); each thread then keeps for
// its sections only what every evaluation reads and beta does not change:
// d, d^2, d*, |s| and sign(s). An evaluation takes 1/beta once and
// multiplies; its two prefix sums (the free energy and the d* term) are one
// scan of pairs: sequential within the thread, a warp scan of the thread
// totals (shuffles), and the warps' totals added in one fixed order through
// shared memory, so every thread sees the same offsets; the max over the
// ray's sections is a warp max and the warps' maxima in shared memory. The
// bisection keeps `round_update`'s midpoints 0.5 (lo + hi), so its
// decisions are the plain version's up to f32 rounding of the bound. The
// pdf's total is a warp sum and the warps' sums in order; the CDF's
// offsets are the same group scan of the normalized pdf, made exactly
// nondecreasing by a running max over the group (exact, so no order can
// break it), and the inverse-CDF bracket is a binary search over it in
// shared memory. The TPU kernel's hi/lo-split bf16 triangular matmuls were
// a workaround for its matrix unit and are not carried over. The
// exponentials are the accurate expf / expm1f, as the plain version's.
// The group's scans and reductions, `Sections` and `error_bound` live in
// `ray_common.cuh`, which K7 (`conv_check.cu`) shares.
#include "ray_common.cuh"

namespace i2sdf {
namespace {

template <int MAXE>
__global__ void __launch_bounds__(kGroupThreads)
sampler_round_kernel(const float* __restrict__ z, const float* __restrict__ sdf,
                     const float* __restrict__ beta_in,
                     const float* __restrict__ u, float* __restrict__ samples,
                     float* __restrict__ beta_out, int S, int n_out,
                     const float* __restrict__ beta0_p, int beta_iters,
                     float eps, float add_tiny, int is_final) {
  extern __shared__ float sm[];
  __shared__ GroupScratch g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray = blockIdx.x;
  float* zs = sm;
  float* ss = zs + S;
  float* cs = ss + S;
  stage_ray(z, sdf, ray, S, zs, ss);
  __syncthreads();

  Sections<MAXE> q;
  q.load(zs, ss, tid, S);

  // ---- beta: converged rays take beta0, the rest bisect ------------------
  const float beta0 = *beta0_p;
  float beta = beta_in[ray];
  if (error_bound(q, beta0, g, warp, lane) <= eps) beta = beta0;
  float lo = beta0, hi = beta;
  for (int it = 0; it < beta_iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (error_bound(q, mid, g, warp, lane) <= eps) hi = mid; else lo = mid;
  }
  beta = hi;

  // ---- weights, pdf ---------------------------------------------------
  float e_ex[MAXE], r_in[MAXE], pdf[MAXE], fo, ro;
  q.prefixes(1.f / beta, e_ex, r_in, pdf, fo, ro);
  group_excl_scan2(fo, ro, g, warp, lane);
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    float p = 0.f;
    if (q.sec(k)) {
      const float trans = expf(-(fo + e_ex[k]));
      p = is_final ? (1.f - expf(-pdf[k])) * trans + 1e-5f
                   : (fminf(expf(ro + r_in[k]), 1e6f) - 1.f) * trans +
                         add_tiny;
    }
    pdf[k] = p;
    tot += p;
  }
  const float total = group_sum(tot, g, warp, lane);

  // ---- CDF (exactly nondecreasing), inverse-CDF draws ------------------
  float lt = 0.f;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    if (q.sec(k)) {
      pdf[k] = total > 0.f ? pdf[k] / fmaxf(total, 1e-30f)
                           : 1.f / (float)(S - 1);
      lt += pdf[k];
      pdf[k] = lt;  // thread-local inclusive sum
    }
  }
  float off = lt, unused = 0.f;
  group_excl_scan2(off, unused, g, warp, lane);
  // the running max: the thread's last value, then the group's exclusive
  // max scan of those, taken into every value
  float last = -FLT_MAX;
#pragma unroll
  for (int k = 0; k < MAXE; ++k)
    if (q.sec(k)) {
      pdf[k] += off;
      last = pdf[k];
    }
  float carry = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, carry, o);
    if (lane >= o) carry = fmaxf(carry, t);
  }
  float excl = __shfl_up_sync(kFull, carry, 1);
  if (lane == 0) excl = -FLT_MAX;
  if (lane == 31) g.red[warp] = carry;
  __syncthreads();
  for (int v = 0; v < warp; ++v) excl = fmaxf(excl, g.red[v]);
  if (tid == 0) cs[0] = 0.f;
#pragma unroll
  for (int k = 0; k < MAXE; ++k)
    if (q.sec(k)) cs[q.base + k + 1] = fmaxf(pdf[k], excl);
  __syncthreads();

  for (int i = tid; i < n_out; i += kGroupThreads) {
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
  if (tid == 0) beta_out[ray] = beta;
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
  if (S < 2 || S > kMaxSamples) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * S * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(E)                                                          \
  sampler_round_kernel<E><<<R, kGroupThreads, smem, st>>>(                 \
      z, sdf, beta_in, u, samples, beta_out, S, n_out, beta0, beta_iters, \
      eps, add_tiny, is_final)
  I2SDF_BY_SAMPLES(S, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
