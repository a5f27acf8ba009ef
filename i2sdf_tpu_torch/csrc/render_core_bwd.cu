// K4 render_core_bwd: the backward of the render core (SDF, its spatial
// gradient and the radiance at a batch of points): the gradients of
// <cot, [grad | sdf | rgb]> with respect to every weight and bias of the
// SDF net and the radiance net, second-order terms included.
//
// Replaces the backward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_train.py:449 get_render_core_op` (pallas_call at :609, body
// `_make_bwd_kernel` at :267-446), reached through the custom-VJP render
// core of the training step (`i2sdf_tpu/models/renderer.py:345-377`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the forward recompute (SDF with the 257-wide head and the
// radiance net), the reverse sweep, the radiance backward, the upward
// and downward sweeps through the SDF net, and its share of the 14
// weight-gradient products, ~7.6 M bf16 flops at the nets' real widths
// (`chip_smoke.py::k4_macs`), against 52 bytes in.
//
// Design. The TPU kernel sums each weight gradient over its sequential
// grid in VMEM; the ~3.2 MB of f32 weight gradients do not fit in an
// SM's 227 KB, and the card's blocks run in parallel. So the work is
// split in three launches:
//
// 1. `sweep_kernel`, 32 points a block, one block per SM (shared memory
//    as K5's: two activation buffers and every hidden layer's activation
//    derivative). It recomputes the forward, runs the radiance backward,
//    the reverse sweep (d sdf / d h), the upward sweep (the transpose of
//    the reverse sweep, which yields the second-order term dz_extra =
//    dr * ah * 100 s (1 - s)) and the downward sweep, each layer a tiled
//    mma.sync product as in K5. For every layer it writes the two bf16
//    operands of that layer's weight gradient to device memory: for an
//    SDF layer dW = da^T r + X^T dz = [da ; X]^T [r ; dz], one product
//    over the two stacked along the points; for a radiance layer
//    X^T dz. The bias gradients are summed over the block's rows in f32,
//    each column by one thread in row order, into one row per block.
// 2. `atb_kernel`: every A^T B over the points, 64 x 64 output tiles,
//    each block one tile over one range of points (split K), mma.sync on
//    fragments gathered from shared memory; the partial sums go to
//    device memory.
// 3. `sum_kernel`: the point ranges' partial sums, and the blocks' bias
//    rows, added in a fixed order, so the result does not change from
//    run to run.
//
// The sweep kernel (`bwd_sweep_kernel<true>`), the products and the sums
// (`launch_bwd`) live in common.cuh, one kernel body with K6's. The
// activation derivative is stashed as q = sigmoid(-|100 z|) with the sign
// bit set where z > 0 (and -0 in softplus's linear region), so both
// s = sigmoid(100 z) and 1 - s keep bf16's relative precision in the
// second-order factor 100 s (1 - s). The encoding's Jacobian is the
// closed form (d sin(f x)/dx = f cos(f x)). Eikonal rows carry zero
// directions and zero rgb, sdf and light cotangents, so only c_grad
// reaches them.
//
// The light head (the TPU op's backward with `lcfg`,
// `fused_train.py:324-348`) is the `kLight` instantiation, taken when
// the light net has layers: c_lm is column 7 of the cotangent rows. In
// the sweep, right after the SDF recompute, the light net runs on
// relu(features) (a third activation buffer, ~19 KB of shared memory),
// staging each layer's input and, for a hidden layer, its first-order
// derivative s = sigmoid(100 z) (the light net's input is not
// differentiated with respect to x, so there is no second-order term);
// dz = c_lm lm (1 - lm) goes back through the transposed light layers,
// dz = dh s replacing s in the staging. The light layers' weight
// gradients join the split-K products and the fixed-order sums, so they
// are bit-stable too. With `detach_light` off, the light net's input
// cotangent, gated by relu'(features), is added in f32 to the features'
// cotangent from the radiance net before the SDF output layer's
// cotangent is stored; with it on, nothing of the light reaches the SDF
// net's sweeps, whose results are the kernel without the light head's.
#include "common.cuh"

// The scratch table (int64, element offsets) is built by
// `i2sdf_tpu_torch/ops/kernels/render_core.py::_BwdPlan` and read in the
// same order by `read_scratch`.
extern "C" int i2sdf_render_core_bwd(
    const float* x, const float* dirs, const float* cot, int n, int np,
    const void* w_fwd, const float* b_sdf, const int* fwd_desc, int n_fwd,
    const void* w_t, const int* t_desc, int n_t, const float* wsdf_col,
    const void* w_rad, const float* b_rad, const int* rad_desc, int n_rad,
    const void* w_radt, const int* radt_desc, int n_radt, const void* w_l,
    const float* b_l, const int* l_desc, int n_l, const void* w_lt,
    const int* lt_desc, int n_lt, int detach_light, int mx, int md, int lda,
    int ldd, int ldg, void* ws16, float* ws32, const long long* table,
    float* out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxSdf || n_rad > kMaxRad || n_t != n_fwd ||
      n_radt != n_rad || n_fwd < 2 || n_l < 0 || n_l > kMaxLight ||
      n_lt != n_l)
    return (int)cudaErrorInvalidValue;
  const Plan fwd = read_plan(fwd_desc, n_fwd), tp = read_plan(t_desc, n_t);
  const Plan rad = read_plan(rad_desc, n_rad);
  const Plan radt = read_plan(radt_desc, n_radt);
  const LightPlan lp = read_light_plan(l_desc, lt_desc, n_l);
  if (n_l > 0)
    return (int)launch_bwd<true, true>(
        x, dirs, cot, nullptr, 0, nullptr, n, np, (const uint2*)w_fwd, b_sdf,
        fwd, (const uint2*)w_t, tp, wsdf_col, (const uint2*)w_rad, b_rad, rad,
        (const uint2*)w_radt, radt, (const uint2*)w_l, b_l,
        (const uint2*)w_lt, lp, detach_light, mx, md, lda, ldd, ldg, ws16,
        ws32, table, out, stream);
  return (int)launch_bwd<true, false>(
      x, dirs, cot, nullptr, 0, nullptr, n, np, (const uint2*)w_fwd, b_sdf,
      fwd, (const uint2*)w_t, tp, wsdf_col, (const uint2*)w_rad, b_rad, rad,
      (const uint2*)w_radt, radt, nullptr, nullptr, nullptr, lp, 1, mx, md,
      lda, ldd, ldg, ws16, ws32, table, out, stream);
}
