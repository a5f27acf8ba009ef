// K10 sdf_outputs: the SDF net's sdf, features and spatial gradient at a
// batch of points, forward only: out = [sdf | features] (N, 1 + F) and
// grad (N, 3), both f32, the sdf clamped to the bounding sphere and the
// gradient the sphere's where the sphere wins.
//
// Replaces the TPU kernel `i2sdf_tpu/ops/pallas/fused_outputs.py:95
// fused_sdf_outputs` (pallas_call at :135, body `_make_kernel` at :35-92;
// the clamp at :159-166): the normal map's inputs at every sample of an
// eval render. Nothing in the JAX package's program calls it; its public
// kernel API exports it (`i2sdf_tpu/ops/pallas/__init__.py`).
//
// What bounds it on the H100: operations. The function's least work at
// the flagship config is the SDF forward with its 257-wide head and the
// reverse sweep of d sdf / d x, ~0.98 M multiply-adds a point
// (`chip_smoke.py::k5_macs`), against 12 bytes in and 1,040 out. This
// kernel's tangent form does more: the three tangents through every
// hidden layer and the sdf column, ~1.9 M a point (`k10_design_macs`).
//
// Design: K3's block (`tangent_form.cuh` on `wgmma_layer.cuh`) on the SDF
// net alone. 32 points a block, their four streams as 128 rows in two m64
// tiles, two consumer warpgroups taking each hidden layer in place and a
// producer warp bulk-copying the stage images of K3's SDF chain
// (`render_core.core_sdf_layers`: the output layer as the sdf alone, then
// the features) into the ring. The sdf product (N = 8) over both tiles
// gives sdf and d sdf / d x, clamped in the epilogue as the TPU kernel's
// wrapper clamps; the features product over tile 0's primal rows (its t_x
// rows ride along) is kept in f32. No radiance net, no PE(dirs). Once
// both warpgroups have retired the products, the two tiles hold the
// block's rows of [sdf | features] in f32, which are contiguous in `out`
// and leave in one coalesced copy.
#include "tangent_form.cuh"

namespace i2sdf {
namespace {

using namespace wg;

constexpr int kTileBytes = 4 * kChunkBytes;  // 64 rows x 256 columns
// the points' coordinates, their encodings and the encoding's three
// tangents, cached in f32
constexpr int kCacheFloats = kPoints * 3 + 4 * kPoints * kPeStride;
constexpr size_t kSmemBytes =
    1024 + 2 * kTileBytes + kRingBytes + kCacheFloats * sizeof(float);
// the block's [sdf | features] rows in f32 fit in the two tiles
static_assert(kPoints * (1 + 256) * sizeof(float) <= 2 * kTileBytes, "");

// The output layer: the sdf tile (`Ls`, N = 8) over both tiles (into the
// heads of a0 and a1), sdf and d sdf / d x from it, the sphere's where it
// is below the net's sdf (the first warpgroup's, the gradient to device
// memory); then this warpgroup's NW feature columns (`Lf`) over tile 0
// (a0). Once both have retired, [sdf | features] of the block's points in
// f32 into the tiles (row stride 1 + F), then out to device memory.
template <int NW>
__device__ __forceinline__ void output_layer(
    float* a0, float* a1, unsigned char* t0, unsigned char* t1, const int* Lf,
    const int* Ls, const float* __restrict__ b_sdf, const float* xs, int F,
    int col0, bool active, int cw, int row0, int n, float sphere_r,
    float sphere_scale, float* __restrict__ out,
    float* __restrict__ grad_out, Ring& ring) {
  const Frag f;
  const int p = 8 * f.w + f.g;
  const bool head = cw == 0 && f.tig == 0;  // holds point p's sdf column
  products<8, 2>(a0, a1, smem_addr(t0), smem_addr(t1), 0, Ls[kK], ring);
  float sdf = 0.f;
  if (head) {
    sdf = a0[0] + b_sdf[Ls[kBOff]];
    float g[3] = {a0[2], a1[0], a1[2]};
    if (sphere_r > 0.f) {
      const float* xp = xs + 3 * p;
      const float norm =
          sqrtf(xp[0] * xp[0] + xp[1] * xp[1] + xp[2] * xp[2]);
      const float sphere = sphere_scale * (sphere_r - norm);
      if (sphere < sdf) {
        sdf = sphere;
        const float inv = -sphere_scale / fmaxf(norm, 1e-12f);
        for (int d = 0; d < 3; ++d) g[d] = xp[d] * inv;
      }
    }
    if (row0 + p < n) {
      float* go = grad_out + (size_t)(row0 + p) * 3;
      for (int d = 0; d < 3; ++d) go[d] = g[d];
    }
  }
  products<NW, 1>(a0, nullptr, smem_addr(t0), 0, col0, Lf[kK], ring);
  bar_sync(1, kConsumers);  // both warpgroups retired: the tiles are free
  const int oc = F + 1;
  float* stage = reinterpret_cast<float*>(t0);  // spills into t1
  if (active) {
    const float* b = b_sdf + Lf[kBOff];
    float* row = stage + p * oc + 1;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
      if (col < F) row[col] = a0[4 * j] + bb.x;
      if (col + 1 < F) row[col + 1] = a0[4 * j + 1] + bb.y;
    }
  }
  if (head) stage[p * oc] = sdf;
  bar_sync(1, kConsumers);
  // the block's rows of `out` are contiguous
  const int m = min(kPoints, n - row0) * oc;
  float* dst = out + (size_t)row0 * oc;
  for (int i = threadIdx.x; i < m; i += kConsumers) dst[i] = stage[i];
}

__global__ void __launch_bounds__(kBlockThreads, 1)
sdf_outputs_kernel(const float* __restrict__ x, int n,
                   const unsigned char* __restrict__ w_sdf,
                   const float* __restrict__ b_sdf, Plan fwd, int mx, int F,
                   float sphere_r, float sphere_scale,
                   float* __restrict__ out, float* __restrict__ grad_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* t0 = align1024(smem_raw);
  unsigned char* t1 = t0 + kTileBytes;
  Ring ring = make_ring(t1 + kTileBytes);
  float* xs = reinterpret_cast<float*>(t1 + kTileBytes + kRingBytes);
  float* px = xs + kPoints * 3;
  float* tx = px + kPoints * kPeStride;
  __syncthreads();
  const int row0 = blockIdx.x * kPoints;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(ring, w_sdf, fwd);
  } else {
    const int cw = threadIdx.x >> 7;
    for (int i = threadIdx.x; i < kPoints * 3; i += kConsumers) {
      const int r = row0 + i / 3;
      xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
    }
    bar_sync(1, kConsumers);
    pe_cache(px, tx, kPoints, xs, mx, threadIdx.x, kConsumers);
    bar_sync(1, kConsumers);
    const Enc enc{px, tx, nullptr, 3 + 6 * mx, 0};
    pe_streams(t0, t1, enc, 0, fwd.L[0][kK], 1.f);
    fence_async();
    bar_sync(1, kConsumers);

    float a0[64], a1[64];
    const int nh = fwd.n - 2;  // then the sdf and the feature products
    for (int l = 0; l < nh; ++l) {
      const int* L = fwd.L[l];
      const Split sp(L[kN], cw);
  #define CALL(W)                                                           \
  tangent_hidden<W>(a0, a1, t0, t1, L, fwd.L[l + 1], b_sdf + L[kBOff],  \
                    enc, sp.col0, sp.active, ring)
      I2SDF_BY_WIDTH(sp.nw, CALL)
  #undef CALL
    }
    const Split sp(fwd.L[nh + 1][kN], cw);
  #define CALL(W)                                                            \
  output_layer<W>(a0, a1, t0, t1, fwd.L[nh + 1], fwd.L[nh], b_sdf, xs, F, \
                  sp.col0, sp.active, cw, row0, n, sphere_r, sphere_scale, \
                  out, grad_out, ring)
    I2SDF_BY_WIDTH(sp.nw, CALL)
  #undef CALL
  }
}

}  // namespace
}  // namespace i2sdf

// `w`, `b` and `desc` are K3's SDF stage chain as
// `i2sdf_tpu_torch/ops/kernels/sdf_outputs.py::OutputStages` packs it
// (the hidden layers, the sdf alone, the features); `mx` the encoding's
// frequency count (0: none), `sphere_r` 0 for no clamp.
extern "C" int i2sdf_sdf_outputs(const float* x, int n, const void* w,
                                 const float* b, const int* desc,
                                 int n_layers, int mx, int F, float sphere_r,
                                 float sphere_scale, float* out,
                                 float* grad_out, void* stream) {
  using namespace i2sdf;
  using namespace i2sdf::wg;
  if (n <= 0) return 0;
  if (n_layers < 3 || n_layers > kMaxLayers || 3 + 6 * mx > kPeStride ||
      F < 1 || F > 256)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)sdf_outputs_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kPoints - 1) / kPoints;
  sdf_outputs_kernel<<<blocks, kBlockThreads, kSmemBytes,
                       (cudaStream_t)stream>>>(
      x, n, (const unsigned char*)w, b, read_plan(desc, n_layers), mx, F,
      sphere_r, sphere_scale, out, grad_out);
  return (int)cudaGetLastError();
}
