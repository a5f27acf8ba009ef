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
//
// The light head of the light-mask config (the TPU op's `lcfg` branch,
// `fused_train.py:173-195,252-256`) is the kernel's `kLight`
// instantiation, taken when the light net has layers (n_l > 0): after the
// SDF output layer, relu(features) goes to a third activation buffer
// (~19 KB more shared memory); at the end of the kernel the light net
// (Softplus(100) hidden layers, its one output column padded to a 16-wide
// tile with zero weights) runs between it and a free buffer of the pair,
// in an out-of-line device function whose registers are allocated apart
// from the sweeps', and a sigmoid epilogue writes the mask (N, 1). At the
// light config (256 -> 128 -> 1) that is ~66 K more flops a point,
// against the ~1.9 M of the SDF sweeps and the radiance net, and 4 more
// bytes out.
#include "common.cuh"

extern "C" int i2sdf_render_core_fwd(
    const float* x, const float* dirs, int n, const void* w_fwd,
    const float* b_sdf, const int* fwd_desc, int n_fwd, const void* w_rev,
    const int* rev_desc, int n_rev, const float* wsdf_col, const void* w_rad,
    const float* b_rad, const int* rad_desc, int n_rad, const void* w_l,
    const float* b_l, const int* l_desc, int n_l, int mx, int md, int lda,
    int ldd, int ldg, float* sdf_out, float* grad_out, float* rgb_out,
    float* lmask_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxLayers || n_rev != n_fwd - 1 || n_rad > kMaxLayers ||
      n_fwd < 2 || n_l < 0 || n_l > kMaxLight)
    return (int)cudaErrorInvalidValue;
  const Plan fwd = read_plan(fwd_desc, n_fwd), rev = read_plan(rev_desc, n_rev);
  const Plan rad = read_plan(rad_desc, n_rad);
  const LightPlan lp = read_light_plan(l_desc, nullptr, n_l);
  if (n_l > 0)
    return (int)launch_fwd_sweep<true, true>(
        x, dirs, n, (const uint2*)w_fwd, b_sdf, fwd, (const uint2*)w_rev, rev,
        wsdf_col, (const uint2*)w_rad, b_rad, rad, (const uint2*)w_l, b_l,
        lp, mx, md, lda, ldd, ldg, 0, sdf_out, grad_out, rgb_out, lmask_out,
        nullptr, stream);
  return (int)launch_fwd_sweep<true, false>(
      x, dirs, n, (const uint2*)w_fwd, b_sdf, fwd, (const uint2*)w_rev, rev,
      wsdf_col, (const uint2*)w_rad, b_rad, rad, nullptr, nullptr, lp, mx, md,
      lda, ldd, ldg, 0, sdf_out, grad_out, rgb_out, nullptr, nullptr, stream);
}
