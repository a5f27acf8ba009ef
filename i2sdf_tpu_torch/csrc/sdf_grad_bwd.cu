// K12 sdf_grad_bwd: the backward of K11, the gradients of <c_out, [sdf |
// features]> + <c_g, grad> with respect to every weight and bias of the
// SDF net, through the spatial gradient (second-order terms included).
//
// Replaces the backward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_grad.py:250 get_sdf_outputs_op` (pallas_call at :323, body
// `_make_bwd_kernel` at :140-225). Like the TPU op it gives no cotangent
// to x (:347).
//
// It computes K6's function: the JAX package's `get_rev_op` has "the same
// contract as `fused_grad.get_sdf_outputs_op`" (`fused_rev.py:215-219`),
// the gradients of the same outputs by the other algorithm. So K12 is K6
// (`rev_bwd.cu`): its wgmma sweep kernel, its `wgrad_kernel<6>` and its
// fixed-order sums, on K6's pack (`rev.RevStages`) and plan
// (`rev.plan_for`), under K12's own name and launch count; on the same
// points, weights and cotangents its output is K6's, bit for bit.
//
// What bounds it on the H100: operations, K6's: the forward recompute of
// the hidden layers, the reverse, upward and downward sweeps and the
// weight-gradient products, ~5.9 M bf16 flops a point at the flagship
// config (`chip_smoke.py::k6_macs`, the function's least work), against
// 1,052 bytes in (x, c_out, c_g).

// rev_bwd.cu
extern "C" int i2sdf_rev_bwd(
    const float* x, const float* c_out, const float* c_g, int n, int blocks,
    int out_cols, const void* w_sdf, const float* b_sdf, const int* fwd_desc,
    int n_fwd, const void* w_t, const int* tsdf_desc, int n_tsdf,
    const float* wsdf, int mx, int F, void* scratch, float* ws32,
    const long long* reg, const long long* script, int n_items,
    const long long* jobs, int n_jobs, const long long* db_host, float* out,
    void* stream);

// The arguments as `i2sdf_rev_bwd` takes them.
extern "C" int i2sdf_sdf_grad_bwd(
    const float* x, const float* c_out, const float* c_g, int n, int blocks,
    int out_cols, const void* w_sdf, const float* b_sdf, const int* fwd_desc,
    int n_fwd, const void* w_t, const int* tsdf_desc, int n_tsdf,
    const float* wsdf, int mx, int F, void* scratch, float* ws32,
    const long long* reg, const long long* script, int n_items,
    const long long* jobs, int n_jobs, const long long* db_host, float* out,
    void* stream) {
  return i2sdf_rev_bwd(x, c_out, c_g, n, blocks, out_cols, w_sdf, b_sdf,
                       fwd_desc, n_fwd, w_t, tsdf_desc, n_tsdf, wsdf, mx, F,
                       scratch, ws32, reg, script, n_items, jobs, n_jobs,
                       db_host, out, stream);
}
