// K5 rev_fwd: the SDF net's outputs and the spatial gradient of its sdf at
// a batch of points: out = [sdf | features] (N, 1 + F) and grad (N, 3),
// both f32.
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_rev.py:213 get_rev_op` (pallas_call at :244, body
// `_make_fwd_kernel` at :115-135), reached through
// `sdf_outputs_fused_rev` (`fused_rev.py:329`): on the training step with
// the normal losses off it gives `grad_theta` of the eikonal points
// (`i2sdf_tpu/models/renderer.py:473-477`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the SDF forward with the 257-wide head and the reverse sweep
// through the hidden layers, ~2.0 M bf16 flops at the net's real widths
// (`chip_smoke.py::k5_macs`), against 12 bytes in and 1,040 out, ~1.9 k
// flops a byte, far above the card's ~295 balance point.
//
// Design: K3 without the radiance net, in K3's own kernel body
// (`fwd_sweep_kernel<false>` in common.cuh). A block of 32 points runs the
// SDF net forward with its activations in shared memory, stashing each
// hidden layer's activation derivative (bf16) for the reverse sweep; the
// output layer writes its 257 columns straight to device memory in the
// net's own order (the kernel's weights keep it, so nothing is permuted);
// the reverse sweep carries d sdf / d h back through the transposed hidden
// layers, the encoding's share gathered at layer 0 and at the skip, and
// the closed-form Jacobian of the encoding gives d sdf / d x. mma.sync
// bf16 tiles with f32 accumulation; wgmma and TMA are later work.
#include "common.cuh"

extern "C" int i2sdf_rev_fwd(const float* x, int n, const void* w_fwd,
                             const float* b_sdf, const int* fwd_desc,
                             int n_fwd, const void* w_rev,
                             const int* rev_desc, int n_rev,
                             const float* wsdf_col, int mx, int lda, int ldd,
                             int ldg, int out_cols, float* out,
                             float* grad_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxLayers || n_rev != n_fwd - 1 || n_fwd < 2)
    return (int)cudaErrorInvalidValue;
  const Plan none{};        // no radiance net
  const LightPlan no_l{};  // no light net
  return (int)launch_fwd_sweep<false, false>(
      x, nullptr, n, (const uint2*)w_fwd, b_sdf, read_plan(fwd_desc, n_fwd),
      (const uint2*)w_rev, read_plan(rev_desc, n_rev), wsdf_col, nullptr,
      nullptr, none, nullptr, nullptr, no_l, mx, 0, lda, ldd, ldg, out_cols,
      nullptr, grad_out, nullptr, nullptr, out, stream);
}
