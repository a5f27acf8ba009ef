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
// Design: K4's backward without the radiance net, on `wgmma_layer.cuh`,
// `wgmma_sweep.cuh` and K4's own SDF sweeps (`sdf_sweep.cuh`), so it rounds
// where K4 rounds:
//
// 1. `k6_sweep_kernel`: 64 points a block, one 64-row activation tile, two
//    consumer warpgroups that split each layer's columns and a producer
//    warp that walks the host's ring table (`render_core.K4Plan.script`
//    built from `rev.RevStages`: no radiance or light items). The forward
//    recompute runs the hidden layers only (nothing downstream reads the
//    output layer's values); the output layer's cotangent is `c_out`, read
//    from device memory in the net's own column order [sdf | features] and
//    written into the tile in the kernel's [features | sdf], and its bias
//    row is each column of `c_out` summed over the block's rows in order
//    (f32). `c_g` enters the upward sweep through the encoding's
//    closed-form Jacobian. Then K4's reverse, upward and downward sweeps,
//    the stash (q, ah, dz_extra) leaving the block through the ring.
// 2. `wgrad_kernel<6>` (`wgmma_sweep.cuh`, K4's and K9's products under
//    K6's name): every dW = X^T dz + da^T r over the points on wgmma,
//    MN-major operands read from the regions the sweep stored.
// 3. `sum_kernel` (common.cuh): the partials and the blocks' bias rows in
//    a fixed order. No atomics, so the result is the same to the bit run
//    to run. Padding rows have zero cotangents and add nothing.
#include "sdf_sweep.cuh"

namespace i2sdf {
namespace {

__global__ void __launch_bounds__(kBlockThreads, 1)
k6_sweep_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  Ctx c;
  c.T = align1024(smem_raw);
  c.a = &a;
  c.it = c.tphase = c.done = 0;
  c.cw = threadIdx.x >> 7;
  KRing ring = make_ring<kSlots>(c.slots());
  if (threadIdx.x == 0) {
    mbar_init(c.tbar(), 1);
    *c.stored() = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int row0 = blockIdx.x * kPts;
  float* xs = Smem::xs(c);
  float* cot = Smem::cot(c);
  for (int i = threadIdx.x; i < kPts * 3; i += kBlockThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < a.n ? a.x[(size_t)r * 3 + i % 3] : 0.f;
  }
  // c_grad in the cotangents' first three columns, as K4 holds it
  for (int i = threadIdx.x; i < kPts * kCot; i += kBlockThreads) {
    const int r = row0 + i / kCot, k = i % kCot;
    cot[i] = r < a.n && k < 3 ? a.cot[(size_t)r * 3 + k] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      run_script(ring, a.script, a.n_items, a.w, c.stored());
    return;
  }
  float acc[64];
  const int ns = a.fwd.n - 1, F = a.F;
  const int out_k = a.tsdf.L[0][kK];
  sdf_forward_hidden(c, acc);
  store_T(c, kRegX, ns - 1, chunks(a.fwd.L[ns][kK]));
  wait_T(c);
  // the output layer's cotangent: column col < F of the tile is feature
  // col, column F the sdf (c_out's columns 1 + col and 0), zero after
  const int w = 64 * chunks(out_k);
  for (int i = threadIdx.x; i < kPts * w; i += kConsumers) {
    const int r = i / w, col = i % w;
    float v = 0.f;
    if (row0 + r < a.n && col <= F)
      v = a.c_out[(size_t)(row0 + r) * a.out_cols + (col < F ? col + 1 : 0)];
    put1(c.T, r, col, v);
  }
  for (int k = threadIdx.x; k <= F; k += kConsumers) {
    float s = 0.f;
    for (int r = 0; r < kPts && row0 + r < a.n; ++r)
      s += a.c_out[(size_t)(row0 + r) * a.out_cols + (k < F ? k + 1 : 0)];
    c.dbrow()[c.db_off(ns - 1) + k] = s;
  }
  fence_async();
  bar_sync(1, kConsumers);
  store_T(c, kRegDz, ns - 1, chunks(out_k));
  sweep_done(c);
  sdf_backward(c, acc);
}

}  // namespace
}  // namespace i2sdf

// `reg`, `script` and `jobs` as `i2sdf_render_core_bwd` takes them, built
// by `i2sdf_tpu_torch/ops/kernels/render_core.py::K4Plan` from
// `rev.RevStages` (the SDF chain as K3's `CoreStages` packs it, the
// transposed chain as `K4Stages`' first rows); `c_g` is (n, 3).
extern "C" int i2sdf_rev_bwd(
    const float* x, const float* c_out, const float* c_g, int n, int blocks,
    int out_cols, const void* w_sdf, const float* b_sdf, const int* fwd_desc,
    int n_fwd, const void* w_t, const int* tsdf_desc, int n_tsdf,
    const float* wsdf, int mx, int F, void* scratch, float* ws32,
    const long long* reg, const long long* script, int n_items,
    const long long* jobs, int n_jobs, const long long* db_host, float* out,
    void* stream) {
  using namespace i2sdf;
  using namespace i2sdf::wg;
  if (n <= 0) return 0;
  if (n_fwd < 3 || n_fwd > kMaxLayers || n_tsdf != n_fwd - 2 ||
      n_jobs > kMaxWJobs || n_fwd - 1 > kRegLayers || 3 + 6 * mx > 64 ||
      out_cols != F + 1)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.cot = c_g;
  a.c_out = c_out;
  a.out_cols = out_cols;
  a.n = n;
  a.w.p[0] = (const unsigned char*)scratch;
  a.w.p[1] = (const unsigned char*)w_sdf;
  a.w.p[4] = (const unsigned char*)w_t;
  a.b_sdf = b_sdf;
  a.wsdf = wsdf;
  a.fwd = read_plan(fwd_desc, n_fwd);
  a.tsdf = read_plan(tsdf_desc, n_tsdf);
  a.mx = mx;
  a.F = F;
  a.reg = reg;
  a.script = script;
  a.n_items = n_items;
  a.scratch = (unsigned char*)scratch;
  WJobs wj;
  SumJobs sj;
  const int grid =
      read_jobs(jobs, n_jobs, db_host, scratch, blocks, ws32, out, wj, sj);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = set_smem((const void*)k6_sweep_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  k6_sweep_kernel<<<blocks, kBlockThreads, kSmemBytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_products<6>(wj, grid, sj, a.scratch, ws32, st);
}
