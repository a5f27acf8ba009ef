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
// What bounds it on the H100: operations. At the flagship config a point
// costs the forward with the 257-wide head (524,544 MACs) and three
// tangent streams through the hidden layers and the head's sdf column
// (3 x 459,008), ~3.8 M bf16 flops (`chip_smoke.py::k10_macs`), against
// 12 bytes in and 1,040 out: ~3.6 k flops a byte, far above the card's
// ~295 balance point.
//
// Design: the tangent sweep of `csrc/tangent_common.cuh`
// (`tangent_fwd_kernel<true>`, one kernel body with K11's): 16 points a
// block, their four streams stacked as 64 rows against each weight
// fragment, no reverse sweep and no stash; the clamp and its gradient
// select in the epilogue. mma.sync bf16 tiles with f32 accumulation;
// wgmma and TMA are later work.
#include "tangent_common.cuh"

extern "C" int i2sdf_sdf_outputs(const float* x, int n, const void* w,
                                 const float* b, const int* desc,
                                 int n_layers, int mx, int lda, int out_cols,
                                 float sphere_r, float sphere_scale,
                                 float* out, float* grad_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_layers > kMaxLayers || n_layers < 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tangent_fwd<true>(
      x, n, (const uint2*)w, b, read_plan(desc, n_layers), mx, lda, out_cols,
      sphere_r, sphere_scale, out, grad_out, stream);
}
