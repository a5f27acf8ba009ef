// Per-ray device code of K7 (`conv_check.cu`), some of it shared with K2
// (`sampler_round.cu`: the warp reductions, the Laplace density's sign,
// each section's d*): in K7 one warp holds one ray, each lane E =
// ceil(S / 32) consecutive samples in registers; prefix sums are a
// sequential f32 sum within the lane plus a warp scan of the lane totals.
// K2 spreads a ray over a group of warps instead.
#pragma once

#include <float.h>

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

  // The ray's samples from its z and sdf rows in shared memory, with
  // each section's width and d* (Theorem-1 triangle bound on the distance
  // to the surface).
  __device__ __forceinline__ void load(const float* zs, const float* ss,
                                       int lane_, int S_) {
    lane = lane_;
    S = S_;
    E = (S + 31) / 32;
    base = lane * E;
#pragma unroll
    for (int k = 0; k < MAXE; ++k) {
      const int j = base + k;
      z[k] = smp(k) ? zs[j] : 0.f;
      s[k] = smp(k) ? ss[j] : 0.f;
      d[k] = 0.f;
      ds[k] = 0.f;
      if (sec(k)) {
        d[k] = zs[j + 1] - z[k];
        ds[k] = section_dstar(d[k], s[k], ss[j + 1]);
      }
    }
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

}  // namespace
}  // namespace i2sdf
