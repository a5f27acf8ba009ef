// K6 rev_bwd: the backward of K5, the gradients of <c_out, [sdf | features]>
// + <c_g, grad> with respect to every weight and bias of the SDF net,
// through the spatial gradient (second-order terms included).
//
// Replaces the backward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_rev.py:213 get_rev_op` (pallas_call at :294, body
// `_make_bwd_kernel` at :138-209; the math in the docstring at :14-31),
// the custom VJP of `grad_theta` on the training step with the normal
// losses off (`i2sdf_tpu/models/renderer.py:473-477`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the forward recompute of the hidden layers, the reverse sweep, the
// upward sweep (the transpose of the reverse sweep) and the downward sweep
// through the SDF net, and its share of the 9 weight-gradient products
// (two per layer), ~5.9 M bf16 flops at the net's real widths
// (`chip_smoke.py::k6_macs`), against 1,052 bytes in (x, c_out, c_g).
//
// Design: K4 without the radiance net, in the same three launches and in
// K4's own kernel body (`bwd_sweep_kernel<false>` and `launch_bwd` in
// common.cuh): a per-point sweep (forward recompute with the q stash,
// reverse sweep, upward sweep with the second-order term dz_extra =
// dr * ah * 100 s (1 - s), downward sweep) that stages each layer's two
// bf16 weight-gradient operands [da ; X] and [r ; dz] in device memory,
// then the split-K A^T B products and the fixed-order sums; no atomics,
// so the result is the same to the bit run to run. Where K4 takes the
// output layer's cotangent from its in-kernel radiance backward, K6 reads
// it from memory: dz of the output layer is c_out, in the net's own column
// order [sdf | features] (the kernel's weights keep that order), and the
// reverse sweep starts from e_sdf in column 0.
#include "common.cuh"

// The scratch table (int64, element offsets) is built by
// `i2sdf_tpu_torch/ops/kernels/render_core.py::_BwdPlan` with no radiance
// layers and read in the same order by `read_scratch`.
extern "C" int i2sdf_rev_bwd(const float* x, const float* c_out,
                             const float* c_g, int n, int np, int out_cols,
                             const void* w_fwd, const float* b_sdf,
                             const int* fwd_desc, int n_fwd, const void* w_t,
                             const int* t_desc, int n_t,
                             const float* wsdf_col, int mx, int lda, int ldd,
                             int ldg, void* ws16, float* ws32,
                             const long long* table, float* out,
                             void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxSdf || n_t != n_fwd || n_fwd < 2)
    return (int)cudaErrorInvalidValue;
  const Plan none{};        // no radiance net
  const LightPlan no_l{};  // no light net
  return (int)launch_bwd<false, false>(
      x, nullptr, nullptr, c_out, out_cols, c_g, n, np, (const uint2*)w_fwd,
      b_sdf, read_plan(fwd_desc, n_fwd), (const uint2*)w_t,
      read_plan(t_desc, n_t), wsdf_col, nullptr, nullptr, none, nullptr,
      none, nullptr, nullptr, nullptr, no_l, 1, mx, 0, lda, ldd, ldg, ws16,
      ws32, table, out, stream);
}
