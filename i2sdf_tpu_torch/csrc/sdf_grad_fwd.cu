// K11 sdf_grad_fwd: the SDF net's outputs and the spatial gradient of its
// sdf at a batch of points by forward-mode tangent streams: out = [sdf |
// features] (N, 1 + F) and grad (N, 3), both f32, unclamped.
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_grad.py:250 get_sdf_outputs_op` (pallas_call at :277, body
// `_make_fwd_kernel` at :118-137, the sweep `_forward_stash` at :87-115),
// the tangent-stream version of `get_rev_op` (K5), with the same
// contract (`fused_rev.py:217`). Nothing in the JAX package's program
// calls it; its public kernel API exports `sdf_outputs_fused_grad`.
//
// What bounds it on the H100: operations. The function's least work at
// the flagship config is the SDF forward with its 257-wide head and the
// reverse sweep of d sdf / d x, ~0.98 M multiply-adds a point
// (`chip_smoke.py::k5_macs`, as K5), against 12 bytes in and 1,040 out;
// the tangent form does ~1.9 M (`tangent_design_macs`).
//
// Design: the mma.sync tangent sweep of `tangent_common.cuh`
// (`tangent_fwd_kernel`). Where K5 stashes every hidden layer's
// activation derivative for a reverse sweep, the three tangents ride
// beside the activations as three more 16-row tiles against each weight
// fragment, scaled by softplus'(z) in registers; the output layer's
// tangent rows compute the sdf column alone.
#include "tangent_common.cuh"

extern "C" int i2sdf_sdf_grad_fwd(const float* x, int n, const void* w,
                                  const float* b, const int* desc,
                                  int n_layers, int mx, int lda, int out_cols,
                                  float* out, float* grad_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_layers > kMaxLayers || n_layers < 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tangent_fwd(x, n, (const uint2*)w, b,
                                 read_plan(desc, n_layers), mx, lda, out_cols,
                                 out, grad_out, stream);
}
