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
#include <float.h>

#include "common.cuh"

namespace i2sdf {
namespace {

constexpr int kRayWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// Exclusive scan over the warp: the inclusive scan shifted up one lane.
// (Not `inclusive - v`: the last sample's free energy is ~1e10 times a
// density, and subtracting it back cancels every other digit.)
__device__ __forceinline__ float warp_excl_scan(float v, int lane) {
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const float prev = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.f : prev;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float laplace(float s, float beta) {
  return (1.f / beta) * (0.5f + 0.5f * sgn(s) * expm1f(-fabsf(s) / beta));
}

template <int MAXE>
struct Ray {
  int lane, base, E, S;  // this lane owns samples [base, base + E)
  float z[MAXE], s[MAXE], d[MAXE], ds[MAXE];  // depth, sdf, width, d*

  // sample base + k is this lane's and opens a section / exists
  __device__ __forceinline__ bool sec(int k) const {
    return k < E && base + k < S - 1;
  }
  __device__ __forceinline__ bool smp(int k) const {
    return k < E && base + k < S;
  }

  // Max over sections of the opacity error bound at beta.
  __device__ float error_bound(float beta) const {
    float e_ex[MAXE], r_in[MAXE];
    float et = 0.f, rt = 0.f;
    const float inv4b2 = 1.f / (4.f * beta * beta);
#pragma unroll
    for (int k = 0; k < MAXE; ++k) {
      e_ex[k] = et;
      if (sec(k)) {
        et += d[k] * laplace(s[k], beta);
        rt += expf(-ds[k] / beta) * d[k] * d[k] * inv4b2;
      }
      r_in[k] = rt;
    }
    const float eo = warp_excl_scan(et, lane), ro = warp_excl_scan(rt, lane);
    float m = -FLT_MAX;
#pragma unroll
    for (int k = 0; k < MAXE; ++k)
      if (sec(k))
        m = fmaxf(m, (fminf(expf(ro + r_in[k]), 1e6f) - 1.f) *
                         expf(-(eo + e_ex[k])));
    return warp_max(m);
  }
};

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
  q.lane = lane;
  q.S = S;
  q.E = (S + 31) / 32;
  q.base = lane * q.E;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    const int j = q.base + k;
    q.z[k] = q.smp(k) ? zs[j] : 0.f;
    q.s[k] = q.smp(k) ? ss[j] : 0.f;
    q.d[k] = 0.f;
    q.ds[k] = 0.f;
    if (q.sec(k)) {
      // d*: Theorem-1 triangle bound on the distance to the surface
      const float a = zs[j + 1] - q.z[k], b = fabsf(q.s[k]);
      const float c = fabsf(ss[j + 1]);
      const bool first = a * a + b * b <= c * c;
      const bool second = a * a + c * c <= b * b;
      const float h = (a + b + c) / 2.f;
      const float area = h * (h - a) * (h - b) * (h - c);
      const bool tri = !first && !second && (b + c - a > 0.f);
      float heron = 2.f * sqrtf(fmaxf(area, 0.f)) / fmaxf(a, 1e-12f);
      if (isnan(heron)) heron = 0.f;
      if (isinf(heron)) heron = FLT_MAX;
      float dstar = (first && !second ? b : 0.f) + (second ? c : 0.f) +
                    (tri ? heron : 0.f);
      if (sgn(ss[j + 1]) * sgn(q.s[k]) != 1.f) dstar = 0.f;
      q.d[k] = a;
      q.ds[k] = dstar;
    }
  }

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
