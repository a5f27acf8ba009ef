// K3 render_core_fwd: SDF, its spatial gradient and the radiance at a batch
// of points along their view directions (the eval forward of the render).
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_train.py:449 get_render_core_op` (pallas_call at :555), reached
// through `render_core_fused` (`fused_train.py:707`), the eval forward at
// `i2sdf_tpu/models/renderer.py:321-334`.
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the SDF forward (~0.99 M flops with the 257-wide head), the
// reverse sweep (~0.93 M) and the radiance net (~0.54 M), ~2.5 M bf16
// flops, against 24 bytes in and 28 out.
//
// Design (`fwd_sweep_kernel` in common.cuh, one kernel body with K5): a
// block of 32 points runs the SDF net forward with activations in
// shared memory, stashing each hidden layer's activation derivative
// (sigmoid(100 z), bf16, 8 x 32 x 264) for the reverse sweep. The output
// layer's columns are permuted host-side to [features | sdf], so the
// 256 features stay in shared memory and become, with PE(dirs) appended,
// the radiance net's input (ReLU hidden layers, sigmoid output). The
// reverse sweep then carries d sdf / d h back through the SDF net with the
// transposed weights (packed separately), adding the encoding's share at
// the skip layer, and the gradient with respect to x comes from the
// closed-form Jacobian of the wide-block encoding: d sin(f x)/dx =
// f cos(f x), d cos(f x)/dx = -f sin(f x). Only sdf, grad and rgb reach
// device memory.
#include "common.cuh"

extern "C" int i2sdf_render_core_fwd(
    const float* x, const float* dirs, int n, const void* w_fwd,
    const float* b_sdf, const int* fwd_desc, int n_fwd, const void* w_rev,
    const int* rev_desc, int n_rev, const float* wsdf_col, const void* w_rad,
    const float* b_rad, const int* rad_desc, int n_rad, int mx, int md,
    int lda, int ldd, int ldg, float* sdf_out, float* grad_out,
    float* rgb_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxLayers || n_rev != n_fwd - 1 || n_rad > kMaxLayers ||
      n_fwd < 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch_fwd_sweep<true>(
      x, dirs, n, (const uint2*)w_fwd, b_sdf, read_plan(fwd_desc, n_fwd),
      (const uint2*)w_rev, read_plan(rev_desc, n_rev), wsdf_col,
      (const uint2*)w_rad, b_rad, read_plan(rad_desc, n_rad), mx, md, lda,
      ldd, ldg, 0, sdf_out, grad_out, rgb_out, nullptr, stream);
}
