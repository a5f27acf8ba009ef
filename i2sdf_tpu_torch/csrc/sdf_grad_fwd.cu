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
// It computes K10's function without the bounding-sphere clamp (the op
// clamps outside, as the TPU op's wrapper does, `fused_grad.py:353`).
// So K11 is K10 (`sdf_outputs.cu`): its kernel, K3's wgmma tangent form
// on the SDF net (`tangent_form.cuh`), launched with sphere radius 0 on
// K10's stage chain, which is the `.sdf` chain of K12's pack
// (`rev.RevStages`, the same bits as `sdf_outputs.OutputStages`), under
// K11's own name and launch count; on the same points and weights its
// output is K10's at sphere 0, bit for bit.

// sdf_outputs.cu
extern "C" int i2sdf_sdf_outputs(const float* x, int n, const void* w,
                                 const float* b, const int* desc,
                                 int n_layers, int mx, int F, float sphere_r,
                                 float sphere_scale, float* out,
                                 float* grad_out, void* stream);

// `w`, `b` and `desc` are the `.sdf` chain of `rev.RevStages` (K3's SDF
// stage chain: the hidden layers, the sdf alone, the features); `mx` the
// encoding's frequency count (0: none).
extern "C" int i2sdf_sdf_grad_fwd(const float* x, int n, const void* w,
                                  const float* b, const int* desc,
                                  int n_layers, int mx, int F, float* out,
                                  float* grad_out, void* stream) {
  return i2sdf_sdf_outputs(x, n, w, b, desc, n_layers, mx, F, 0.f, 1.f, out,
                           grad_out, stream);
}
