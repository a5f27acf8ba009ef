// Per-ray device code of K2 (`sampler_round.cu`) and K7 (`conv_check.cu`):
// a ray on a group of kGroupWarps warps (128 threads, one block), each
// thread owning E = ceil(S / 128) consecutive samples in registers. The
// group's scans and reductions run in one fixed order (sequential within
// a thread, shuffles within a warp, the warps' results in warp order
// through shared memory), so every thread sees the same offsets and
// maxima. The error bound (`error_bound`) is K2's: K7 evaluates it at
// beta0 alone, so its flag is K2's beta0 decision bit for bit.
#pragma once

#include <float.h>

namespace i2sdf {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroupWarps = 4;
constexpr int kGroupThreads = kGroupWarps * 32;

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

// Theorem-1 triangle bound d* on the distance to the surface within a
// section of width a whose ends have sdf s0 and s1 (0 where they differ in
// sign).
__device__ __forceinline__ float section_dstar(float a, float s0, float s1) {
  const float b = fabsf(s0), c = fabsf(s1);
  const bool first = a * a + b * b <= c * c;
  const bool second = a * a + c * c <= b * b;
  const float h = (a + b + c) / 2.f;
  const float area = h * (h - a) * (h - b) * (h - c);
  const bool tri = !first && !second && (b + c - a > 0.f);
  float heron = 2.f * sqrtf(fmaxf(area, 0.f)) / fmaxf(a, 1e-12f);
  if (isnan(heron)) heron = 0.f;
  if (isinf(heron)) heron = FLT_MAX;
  const float dstar = (first && !second ? b : 0.f) + (second ? c : 0.f) +
                      (tri ? heron : 0.f);
  return sgn(s1) * sgn(s0) != 1.f ? 0.f : dstar;
}

// The group's shared scratch: the warps' scan totals (pairs) and their
// maxima / sums. One buffer is enough: a thread reads the totals before the
// barrier that precedes any thread's next write of the maxima, and the
// maxima before the barrier that precedes the next write of the totals.
struct GroupScratch {
  float tot[2][kGroupWarps];
  float red[kGroupWarps];
};

// Exclusive scan of (a, b) over the group's threads in thread order: the
// warp's inclusive scan shifted up one lane, plus the earlier warps'
// totals added in order (the same sum on every thread). (Not `inclusive -
// v`: the last sample's free energy is ~1e10 times a density, and
// subtracting it back cancels every other digit.)
__device__ __forceinline__ void group_excl_scan2(float& a, float& b,
                                                 GroupScratch& g, int warp,
                                                 int lane) {
  float ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ta = __shfl_up_sync(kFull, ia, o);
    const float tb = __shfl_up_sync(kFull, ib, o);
    if (lane >= o) {
      ia += ta;
      ib += tb;
    }
  }
  float ea = __shfl_up_sync(kFull, ia, 1), eb = __shfl_up_sync(kFull, ib, 1);
  if (lane == 0) ea = eb = 0.f;
  if (lane == 31) {
    g.tot[0][warp] = ia;
    g.tot[1][warp] = ib;
  }
  __syncthreads();
  float oa = 0.f, ob = 0.f;
  for (int v = 0; v < warp; ++v) {
    oa += g.tot[0][v];
    ob += g.tot[1][v];
  }
  a = oa + ea;
  b = ob + eb;
}

__device__ __forceinline__ float group_max(float v, GroupScratch& g, int warp,
                                           int lane) {
  v = warp_max(v);
  if (lane == 0) g.red[warp] = v;
  __syncthreads();
  float m = g.red[0];
#pragma unroll
  for (int w = 1; w < kGroupWarps; ++w) m = fmaxf(m, g.red[w]);
  return m;
}

__device__ __forceinline__ float group_sum(float v, GroupScratch& g, int warp,
                                           int lane) {
  v = warp_sum(v);
  if (lane == 0) g.red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kGroupWarps; ++w) s += g.red[w];
  return s;
}

// A thread's samples [base, base + E) of one ray, with what every
// evaluation reads of each section (sample j < S - 1).
template <int MAXE>
struct Sections {
  int base, E, S;
  float d[MAXE], d2[MAXE], ds[MAXE], as[MAXE], sg[MAXE];

  __device__ __forceinline__ bool sec(int k) const {
    return k < E && base + k < S - 1;
  }

  __device__ __forceinline__ void load(const float* zs, const float* ss,
                                       int tid, int S_) {
    S = S_;
    E = (S + kGroupThreads - 1) / kGroupThreads;
    base = tid * E;
#pragma unroll
    for (int k = 0; k < MAXE; ++k) {
      const int j = base + k;
      d[k] = d2[k] = ds[k] = as[k] = sg[k] = 0.f;
      if (sec(k)) {
        d[k] = zs[j + 1] - zs[j];
        d2[k] = d[k] * d[k];
        ds[k] = section_dstar(d[k], ss[j], ss[j + 1]);
        as[k] = fabsf(ss[j]);
        sg[k] = sgn(ss[j]);
      }
    }
  }

  // The Laplace density at section k, 1/beta = ib.
  __device__ __forceinline__ float density(int k, float ib) const {
    return ib * (0.5f + 0.5f * sg[k] * expm1f(-as[k] * ib));
  }

  // This thread's exclusive free-energy prefix e_ex and inclusive d*-term
  // prefix r_in at each sample, and their totals.
  __device__ __forceinline__ void prefixes(float ib, float* e_ex, float* r_in,
                                           float* fe, float& et,
                                           float& rt) const {
    const float q = 0.25f * ib * ib;
    et = rt = 0.f;
#pragma unroll
    for (int k = 0; k < MAXE; ++k) {
      e_ex[k] = et;
      fe[k] = 0.f;
      if (sec(k)) {
        fe[k] = d[k] * density(k, ib);
        et += fe[k];
        rt += expf(-ds[k] * ib) * d2[k] * q;
      }
      r_in[k] = rt;
    }
  }
};

// This thread's max over its sections of the opacity error bound at beta
// (the group's scans inside: every thread of the group calls it).
template <int MAXE>
__device__ __forceinline__ float sections_max(const Sections<MAXE>& q,
                                              float beta, GroupScratch& g,
                                              int warp, int lane) {
  float e_ex[MAXE], r_in[MAXE], fe[MAXE], eo, ro;
  q.prefixes(1.f / beta, e_ex, r_in, fe, eo, ro);
  group_excl_scan2(eo, ro, g, warp, lane);
  float m = -FLT_MAX;
#pragma unroll
  for (int k = 0; k < MAXE; ++k)
    if (q.sec(k))
      m = fmaxf(m, (fminf(expf(ro + r_in[k]), 1e6f) - 1.f) *
                       expf(-(eo + e_ex[k])));
  return m;
}

// Max over the ray's sections of the opacity error bound at beta.
template <int MAXE>
__device__ __forceinline__ float error_bound(const Sections<MAXE>& q,
                                             float beta, GroupScratch& g,
                                             int warp, int lane) {
  return group_max(sections_max(q, beta, g, warp, lane), g, warp, lane);
}

// The ray's z and sdf rows into shared memory (zs, ss), coalesced; the
// caller syncs after.
__device__ __forceinline__ void stage_ray(const float* __restrict__ z,
                                          const float* __restrict__ sdf,
                                          int ray, int S, float* zs,
                                          float* ss) {
  for (int j = threadIdx.x; j < S; j += kGroupThreads) {
    zs[j] = z[(size_t)ray * S + j];
    ss[j] = sdf[(size_t)ray * S + j];
  }
}

// The largest S the kernels take: E <= 8 samples a thread.
constexpr int kMaxSamples = 8 * kGroupThreads;

// CALL(E) at the per-thread sample count both kernels instantiate for S.
#define I2SDF_BY_SAMPLES(S, CALL)     \
  if ((S) <= 2 * kGroupThreads)       \
    CALL(2);                          \
  else if ((S) <= 4 * kGroupThreads)  \
    CALL(4);                          \
  else                                \
    CALL(8);

}  // namespace
}  // namespace i2sdf
