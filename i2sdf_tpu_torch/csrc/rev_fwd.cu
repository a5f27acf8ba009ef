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
// through the hidden layers down to the encoding, ~2.0 M bf16 flops at the
// net's real widths (`chip_smoke.py::k5_macs`), against 12 bytes in and
// 1,040 out, ~1.9 k flops a byte, far above the card's ~295 balance point.
// What a block loses is latency instead: 18 dependent layer products, and
// at the normal-off step's 4,800 points the launch is one partial wave (75
// blocks), so one block's time is the kernel's.
//
// Design: K6's sweep (`rev_bwd.cu`) without its backward, on the same
// pack (`rev.RevStages`: K3's SDF stage chain, K4's transposed chain, and
// W_0^T as that chain's last row) and the same device code
// (`sdf_sweep.cuh`, `wgmma_sweep.cuh`, `wgmma_layer.cuh`). A block holds 64
// points in one activation tile; two consumer warpgroups split each
// layer's columns and run wgmma from shared memory on weight stages that
// a producer warp bulk-copies into a five-slot ring in the order of a
// host-built table (`rev.K5Plan.script`):
//
// 1. the hidden layers (`sdf_forward_hidden<true>`): h into the tile,
//    each layer's stash q of s = softplus'(z) (K6's, `stash_q`, but in
//    f32, as the TPU kernel holds s) to a scratch region through the ring
//    (no operand stores: nothing here takes a weight gradient). Layer 0
//    reads the encoding as a hi/lo pair, [bf16(PE) | PE - bf16(PE)] on
//    W_0's stages twice (K = 64 + 64): PE's rounding in z_0, which the
//    encoding's high frequencies carry into the gradient, is the share of
//    the gradient's error at points of the scene cube that one more
//    64-deep chunk removes (without it K5 was past the TPU kernel's
//    tolerance at one of 4,800 such points). Layers 1 .. n-1 are K6's
//    code, but from layer 0 on K5's activations are not K6's bits;
// 2. the output layer as K3 takes it, the sdf alone (N = 8) and the
//    features, the accumulators plus bias written to device memory in
//    the net's order [sdf | features] (`out_layer`);
// 3. the reverse sweep (`rev_first<true>`, `rev_layer<W, true>`): r = W_last
//    [:, sdf] s through the transposed hidden layers, each layer's q
//    brought back through the ring, down to layer 0; the encoding's
//    columns of the skip layer and all of layer 0's product added into
//    d sdf / d PE (f32, shared memory);
// 4. the encoding's closed-form Jacobian, d sin(f x)/dx = f cos(f x),
//    d cos(f x)/dx = -f sin(f x) (accurate sinf / cosf), gives grad.
#include "sdf_sweep.cuh"

namespace i2sdf {
namespace {

// K5's output layer, one of its two products over T (the last hidden
// layer's h): the sdf alone (kSdf; column 0 real) or the features; each
// real column of the block's rows, plus its bias, to device memory in the
// net's order [sdf | features].
template <int NW, bool kSdf>
__device__ __forceinline__ void out_layer(Ctx& c, float* acc, const int* L,
                                          const Split& sp) {
  product<NW>(c, acc, L, sp.col0);
  if (!sp.active) return;
  const Args& a = *c.a;
  const Frag f;
  const float* b = a.b_sdf + L[kBOff];
  const int row0 = blockIdx.x * kPts;
  const int width = kSdf ? 1 : a.F;
  const int first = kSdf ? 0 : 1;  // [sdf | features]
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row() + 8 * h;
      if (row0 + row >= a.n) continue;
      float* o = a.out + (size_t)(row0 + row) * a.out_cols + first;
      if (col < width) o[col] = acc[4 * j + 2 * h] + b[col];
      if (col + 1 < width) o[col + 1] = acc[4 * j + 2 * h + 1] + b[col + 1];
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
k5_sweep_kernel(const __grid_constant__ Args a) {
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
  float* gpe = Smem::gpe(c);
  for (int i = threadIdx.x; i < kPts * 3; i += kBlockThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < a.n ? a.x[(size_t)r * 3 + i % 3] : 0.f;
  }
  for (int i = threadIdx.x; i < kPts * kPeStride; i += kBlockThreads)
    gpe[i] = 0.f;
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      run_script(ring, a.script, a.n_items, a.w, c.stored());
    return;
  }
  float acc[64];
  const int ns = a.fwd.n - 1;
  // 1. the hidden layers; their q stash complete in device memory
  sdf_forward_hidden<true>(c, acc);
  sweep_done(c);
  // 2. the output layer: the sdf alone (N = 8), then the features
  out_layer<8, true>(c, acc, a.fwd.L[ns - 1], Split(8, c.cw));
  {
    const Split sp(a.fwd.L[ns][kN], c.cw);
#define CALL(W) out_layer<W, false>(c, acc, a.fwd.L[ns], sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  // 3. the reverse sweep down to the encoding
  rev_first<true>(c);
  for (int l = ns - 2; l >= 0; --l) {
    const Split sp(a.tsdf.L[ns - 1 - l][kN], c.cw);
#define CALL(W) rev_layer<W, true>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  // 4. the encoding's Jacobian
  const int mx = a.mx;
  for (int i = threadIdx.x; i < kPts * 3; i += kConsumers) {
    const int r = i / 3, d = i % 3;
    if (row0 + r >= a.n) continue;
    const float* gp = gpe + r * kPeStride;
    const float xd = xs[3 * r + d];
    float g = gp[d];
    for (int j = 0; j < mx; ++j) {
      const float f = ldexpf(1.f, j);
      g += f * (gp[3 + d * mx + j] * cosf(xd * f) -
                gp[3 + 3 * mx + d * mx + j] * sinf(xd * f));
    }
    a.grad[(size_t)(row0 + r) * 3 + d] = g;
  }
}

}  // namespace
}  // namespace i2sdf

// `fwd_desc`, `reg` and `script` as `rev.K5Plan` builds them from
// `rev.RevStages`: the SDF chain's rows with 64 added to layer 0's K (the
// encoding's hi/lo pair, the low half from column 64), the q stash's regions of the scratch, and the
// ring table (weight stages from the SDF chain, base 1, layer 0's twice,
// and the transposed chain, base 4; the stash from the scratch, base 0).
// `t_desc` holds the transposed chain's rows, the SDF net's layers n-1 ..
// 0.
extern "C" int i2sdf_rev_fwd(const float* x, int n, int blocks,
                             int out_cols, const void* w_sdf,
                             const float* b_sdf, const int* fwd_desc,
                             int n_fwd, const void* w_t, const int* t_desc,
                             int n_t, const float* wsdf, int mx, int F,
                             void* scratch, const long long* reg,
                             const long long* script, int n_items,
                             float* out, float* grad, void* stream) {
  using namespace i2sdf;
  using namespace i2sdf::wg;
  if (n <= 0) return 0;
  if (n_fwd < 3 || n_fwd > kMaxLayers || n_t != n_fwd - 1 ||
      n_fwd - 2 > kRegLayers || 3 + 6 * mx > 64 || out_cols != F + 1 ||
      fwd_desc[(n_fwd - 2) * 8 + kN] != 8 || fwd_desc[kK] <= 64 ||
      fwd_desc[kK] > 128 ||
      blocks * kPts < n)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x;
  a.out = out;
  a.grad = grad;
  a.out_cols = out_cols;
  a.n = n;
  a.w.p[0] = (const unsigned char*)scratch;
  a.w.p[1] = (const unsigned char*)w_sdf;
  a.w.p[4] = (const unsigned char*)w_t;
  a.b_sdf = b_sdf;
  a.wsdf = wsdf;
  a.fwd = read_plan(fwd_desc, n_fwd);
  a.tsdf = read_plan(t_desc, n_t);
  a.mx = mx;
  a.F = F;
  a.reg = reg;
  a.script = script;
  a.n_items = n_items;
  a.scratch = (unsigned char*)scratch;
  cudaError_t err = set_smem((const void*)k5_sweep_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  k5_sweep_kernel<<<blocks, kBlockThreads, kSmemBytes, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
