// K9 bg_core_bwd: the weight and bias gradients of the NeRF++ background's
// pair of MLPs, from the cotangents (c_sigma, c_rgb) of its outputs,
// summed over all points. No cotangent for the points or the directions:
// nothing upstream of them is trainable.
//
// Replaces the backward of the TPU kernel `i2sdf_tpu/ops/pallas/fused_bg.py:
// 209 get_bg_core_op` (pallas_call at :328, `_make_bwd_kernel` at
// :121-206).
//
// What bounds it on the H100: operations, ~3x K8's (forward recompute,
// one transposed product a layer, one weight-gradient product a layer:
// ~1.5 M multiply-adds a point at the background config), against ~56
// bytes a point (x4, dirs and the four cotangents in) and the gradients
// out once.
//
// Design: K4's (`render_core_bwd.cu`) without the second order, two
// launches and the fixed-order sums on `wgmma_layer.cuh`:
//
// 1. `bg_sweep_kernel`: 64 points a block, one 64-row tile T (five
//    64-column chunks) in shared memory, two consumer warpgroups that
//    split each layer's columns and a producer warp that walks the ring
//    table the host builds (`bg_core.BgPlan.script`, `wgmma_sweep.cuh`'s
//    `run_script`): weight stages, staging slots handed out empty, stash
//    and mask tiles, and a wait until the sweep's stores are complete.
//    Every step is a wgmma product of T with a layer's stage images,
//    written in place after both warpgroups retire:
//    - the forward recompute on K8's stages (`BgStages.imp`, a 256-wide
//      layer's two 128-row passes of a chunk copied side by side into one
//      slot), the features product but not sigma's; each hidden layer's
//      s = softplus100'(z) is written into a staging slot and leaves the
//      block by one bulk copy (eight layers' s at 64 rows are 256 KB,
//      more than fits beside the ring);
//    - the radiance net forward, rgb to shared memory;
//    - sigmoid's cotangent at the radiance output, then the radiance
//      backward through W^T stage images (`BgStages.t`), the ReLU mask
//      read back from the layer's stored input;
//    - the features' cotangent from the radiance input layer joined by
//      c_sigma in the implicit output layer's dz [features | sigma];
//    - the implicit backward, dz_{l-1} = (dz_l W_l^T) * s_{l-1} on the
//      hidden part of layer l's input (a skip's encoding rows dropped,
//      its 1/sqrt(2) applied), s_{l-1} brought back as a ring stage.
//    Before each product T, the layer's weight-gradient operand (its input
//    X_l or its output cotangent dz_l), is bulk-copied to the block's
//    operand region as it sits. The bias gradients are summed in f32 over
//    the block's rows in a fixed order (warp shuffles, then four warps in
//    order) into the block's bias row.
// 2. `wgrad_kernel<9>` (`wgmma_sweep.cuh`, K4's products): every dW_l =
//    X_l^T dz_l over the points on wgmma with both operands MN-major.
// 3. `sum_kernel` (common.cuh): the partials and the blocks' bias rows
//    added in a fixed order, so the result does not change from run to
//    run.
//
// The forward recompute's activations, the encodings and rgb take the
// accurate expf, log1pf, sinf and cosf (common.cuh), as the plain op does.
// Padding rows carry zero cotangents, so every weight-gradient pair has a
// zero side there and they add nothing. The chain rule to weight norm's
// (v, g) stays in PyTorch, outside.
#include "bg_common.cuh"
#include "wgmma_sweep.cuh"

namespace i2sdf {
namespace {

using namespace wg;

constexpr int kBgCot = 4;                    // [c_sigma | c_rgb]

struct Args {
  const float* x4;
  const float* dirs;
  const float* cot;
  int n;
  Bases w;                 // [scratch, implicit, radiance, -, transposed]
  const float* b_imp;      // the implicit stage chain's biases
  const float* b_rad;      // the radiance chain's
  Plan imp, timp, rad, trad;
  int d_in, fx, fv, F;
  const long long* reg;    // regions, then the bias rows' offsets
  const long long* script;
  int n_items;
  unsigned char* scratch;
};

// The consumers' state and shared memory (`SweepCtx`): after the ring,
// the points, directions, cotangents and rgb.
constexpr int kRest = kPts * (4 + 3 + kBgCot + 8);
using Ctx = SweepCtx<Args, kRest>;
constexpr size_t kSmemBytes = Ctx::kSmemBytes;

struct Smem {
  static __device__ __forceinline__ float* xs(const Ctx& c) {
    return c.rest();
  }
  static __device__ __forceinline__ float* ds(const Ctx& c) {
    return xs(c) + kPts * 4;
  }
  static __device__ __forceinline__ float* cot(const Ctx& c) {
    return ds(c) + kPts * 3;
  }
  static __device__ __forceinline__ float* rgb(const Ctx& c) {
    return cot(c) + kPts * kBgCot;
  }
};

// scale * PE(x4) or PE(dirs) into columns [col0, kend) of T.
__device__ __forceinline__ void fill_T(Ctx& c, bool view, int col0, int kend,
                                       float scale) {
  const Args& a = *c.a;
  if (view)
    fill_pe(c.T, Smem::ds(c), 3, a.fv, col0, kend, scale, threadIdx.x,
            kConsumers);
  else
    fill_pe(c.T, Smem::xs(c), a.d_in, a.fx, col0, kend, scale, threadIdx.x,
            kConsumers);
}

// ---- the sweeps, one layer each -------------------------------------------

// Forward recompute, hidden implicit layer l: h into T (the encoding at
// the next layer's skip columns), s to its stash.
template <int NW>
__device__ __forceinline__ void fwd_hidden(Ctx& c, float* acc, int l,
                                           const Split& sp) {
  const int* L = c.a->imp.L[l];
  const int* nx = c.a->imp.L[l + 1];
  product<NW>(c, acc, L, sp.col0);
  const int s = take(c);
  unsigned char* S = c.slot(s);
  if (sp.active) {
    const Frag f;
    const float scale = (L[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const float* b = c.a->b_imp + L[kBOff];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z0 = acc[4 * j + 2 * h] + bb.x;
        const float z1 = acc[4 * j + 2 * h + 1] + bb.y;
        put_pair(c.T, f.row() + 8 * h, col, softplus100(z0) * scale,
                 softplus100(z1) * scale);
        put_pair(S, f.row() + 8 * h, col, dsoftplus100(z0),
                 dsoftplus100(z1));
      }
    }
  }
  if (nx[kFlags] & kSkipIn) {
    bar_sync(1, kConsumers);
    fill_T(c, false, nx[kCol], nx[kK], kInvSqrt2);
  }
  fence_async();
  stage_out(c, s, -1, kRegQ, l, (uint32_t)chunks(L[kN]) * kChunkBytes);
}

// Forward recompute, the output layer's feature columns into T.
template <int NW>
__device__ __forceinline__ void fwd_features(Ctx& c, float* acc, const int* L,
                                             const Split& sp) {
  product<NW>(c, acc, L, sp.col0);
  if (sp.active) {
    const Frag f;
    const float* b = c.a->b_imp + L[kBOff];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
      put_pair(c.T, f.row(), col, acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      put_pair(c.T, f.row() + 8, col, acc[4 * j + 2] + bb.x,
               acc[4 * j + 3] + bb.y);
    }
  }
  fence_async();
  bar_sync(1, kConsumers);
}

// A radiance layer forward: a hidden layer's relu into T, the last
// layer's rgb (all eight columns of its N = 8 product) to shared memory.
template <int NW, bool last>
__device__ __forceinline__ void rad_fwd(Ctx& c, float* acc, int l,
                                        const Split& sp) {
  const int* L = c.a->rad.L[l];
  const float* b = c.a->b_rad + L[kBOff];
  product<NW>(c, acc, L, sp.col0);
  if (sp.active) {
    const Frag f;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float z0 = acc[4 * j + 2 * h] + bb.x;
        const float z1 = acc[4 * j + 2 * h + 1] + bb.y;
        if constexpr (last)
          *reinterpret_cast<float2*>(Smem::rgb(c) + row * 8 + col) =
              make_float2(1.f / (1.f + expf(-z0)), 1.f / (1.f + expf(-z1)));
        else
          put_pair(c.T, row, col, fmaxf(z0, 0.f), fmaxf(z1, 0.f));
      }
    }
  }
  fence_async();
  bar_sync(1, kConsumers);
}

// A radiance layer backward (l >= 1): dz_{l-1} = (dz_l W_l^T) * relu'
// (the mask from layer l's input, brought back) into T; its bias row.
template <int NW>
__device__ __forceinline__ void rad_bwd(Ctx& c, float* acc, int l,
                                        const Split& sp) {
  const Args& a = *c.a;
  product<NW>(c, acc, a.trad.L[a.rad.n - 1 - l], sp.col0);
  const int s = take(c);
  const unsigned char* M = c.slot(s);
  if (sp.active) {
    const Frag f;
    float v[4];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float2 m = get_pair(M, row, col);
        v[2 * h] = m.x > 0.f ? acc[4 * j + 2 * h] : 0.f;
        v[2 * h + 1] = m.y > 0.f ? acc[4 * j + 2 * h + 1] : 0.f;
        put_pair(c.T, row, col, v[2 * h], v[2 * h + 1]);
      }
      col_sums(c.wsum(), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  release(c, s);
  bias_row(c, c.db_off(a.imp.n - 1 + l - 1), a.rad.L[l - 1][kReal]);
  fence_async();
  bar_sync(1, kConsumers);
}

// The radiance net's first layer backward: c_feat = dz_0 W_0^T on the
// feature columns, then the implicit output layer's cotangent [c_feat |
// c_sigma | 0] into T and its bias row.
template <int NW>
__device__ __forceinline__ void rad_first_bwd(Ctx& c, float* acc,
                                              const Split& sp) {
  const Args& a = *c.a;
  const int F = a.F;
  product<NW>(c, acc, a.trad.L[a.rad.n - 1], sp.col0);
  if (sp.active) {
    const Frag f;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
      const float* v = acc + 4 * j;
      put_pair(c.T, f.row(), col, v[0], v[1]);
      put_pair(c.T, f.row() + 8, col, v[2], v[3]);
      col_sums(c.wsum(), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  // the sigma column carries c_sigma; the padding columns are zero
  // (written after the product's columns past F)
  bar_sync(1, kConsumers);
  for (int i = threadIdx.x; i < kPts * (kWsumCols - F); i += kConsumers) {
    const int r = i / (kWsumCols - F), col = F + i % (kWsumCols - F);
    put1(c.T, r, col, col == F ? Smem::cot(c)[r * kBgCot] : 0.f);
  }
  const int ni = a.imp.n - 1;   // the implicit net's layers
  bias_row(c, c.db_off(ni - 1), F);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < kPts; ++r) s += Smem::cot(c)[r * kBgCot];
    c.dbrow()[c.db_off(ni - 1) + F] = s;
  }
  fence_async();
  bar_sync(1, kConsumers);
}

// Implicit backward through W_l^T (l = ni-1 .. 1, its rows cut to the
// hidden part of the layer's input): dz_{l-1} = scale (dz_l W_l^T)
// s_{l-1} on the hidden columns into T; its bias row.
template <int NW>
__device__ __forceinline__ void imp_bwd(Ctx& c, float* acc, int l,
                                        const Split& sp) {
  const Args& a = *c.a;
  const int nh = a.imp.n - 2;
  const int* Lt = a.timp.L[nh - l];
  product<NW>(c, acc, Lt, sp.col0);
  const int sq = take(c);
  if (sp.active) {
    const Frag f;
    const float scale = (Lt[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const int n_h = Lt[kReal];
    const unsigned char* S = c.slot(sq);
    float v[4];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        // no branch on a value of the accumulators (ptxas would serialize
        // the wgmma): the stash is read whole, masked by select
        const float2 s = get_pair(S, row, col);
        v[2 * h] = col < n_h ? acc[4 * j + 2 * h] * scale * s.x : 0.f;
        v[2 * h + 1] =
            col + 1 < n_h ? acc[4 * j + 2 * h + 1] * scale * s.y : 0.f;
        put_pair(c.T, row, col, v[2 * h], v[2 * h + 1]);
      }
      col_sums(c.wsum(), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  release(c, sq);
  bias_row(c, c.db_off(l - 1), a.imp.L[l - 1][kReal]);
  fence_async();
  bar_sync(1, kConsumers);
}

__device__ __forceinline__ void consume(Ctx& c) {
  const Args& a = *c.a;
  // one accumulator array for every product of the kernel (a warpgroup's
  // N <= 128 half of a layer), as K4's
  float acc[64];
  const int ni = a.imp.n - 1, nh = ni - 1, nr = a.rad.n, F = a.F;

  // ---- 1. implicit forward: X_l stored, s_l staged; the features in T ---
  fill_T(c, false, 0, a.imp.L[0][kK], 1.f);
  fence_async();
  bar_sync(1, kConsumers);
  for (int l = 0; l < nh; ++l) {
    store_T(c, kRegX, l, chunks(a.imp.L[l][kK]));
    const Split sp(a.imp.L[l][kN], c.cw);
#define CALL(W) fwd_hidden<W>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  {
    const int* L = a.imp.L[ni];   // imp.L[nh] is sigma's, not needed here
    store_T(c, kRegX, nh, chunks(L[kK]));
    const Split sp(L[kN], c.cw);
#define CALL(W) fwd_features<W>(c, acc, L, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  sweep_done(c);

  // ---- 2. radiance forward: its inputs stored, rgb to shared memory ------
  fill_T(c, true, F, a.rad.L[0][kK], 1.f);
  fence_async();
  bar_sync(1, kConsumers);
  for (int l = 0; l < nr; ++l) {
    store_T(c, kRegRx, l, chunks(a.rad.L[l][kK]));
    const Split sp(a.rad.L[l][kN], c.cw);
    if (l < nr - 1) {
#define CALL(W) rad_fwd<W, false>(c, acc, l, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    } else {
#define CALL(W) rad_fwd<W, true>(c, acc, l, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    }
  }
  sweep_done(c);

  // ---- 3. the radiance output's dz = c_rgb rgb (1 - rgb), its backward ---
  {
    const int d_out = a.rad.L[nr - 1][kReal];
    for (int i = threadIdx.x; i < kPts * 64; i += kConsumers) {
      const int r = i >> 6, col = i & 63;
      float v = 0.f;
      if (col < d_out) {
        const float g = Smem::rgb(c)[r * 8 + col];
        v = Smem::cot(c)[r * kBgCot + 1 + col] * g * (1.f - g);
      }
      put1(c.T, r, col, v);
    }
    if (threadIdx.x < d_out) {
      const int k = threadIdx.x;
      float s = 0.f;
      for (int r = 0; r < kPts; ++r) {
        const float g = Smem::rgb(c)[r * 8 + k];
        s += Smem::cot(c)[r * kBgCot + 1 + k] * g * (1.f - g);
      }
      c.dbrow()[c.db_off(ni + nr - 1) + k] = s;
    }
    fence_async();
    bar_sync(1, kConsumers);
  }
  for (int l = nr - 1; l >= 1; --l) {
    store_T(c, kRegRdz, l, chunks(a.rad.L[l][kN]));
    const Split sp(a.trad.L[nr - 1 - l][kN], c.cw);
#define CALL(W) rad_bwd<W>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  store_T(c, kRegRdz, 0, chunks(a.rad.L[0][kN]));
  {
    const Split sp(a.trad.L[nr - 1][kN], c.cw);
#define CALL(W) rad_first_bwd<W>(c, acc, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  store_T(c, kRegDz, nh, chunks(F + 1));

  // ---- 4. implicit backward: dz_l stored, bias rows ----------------------
  for (int l = nh; l >= 1; --l) {
    const Split sp(a.timp.L[nh - l][kN], c.cw);
#define CALL(W) imp_bwd<W>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    store_T(c, kRegDz, l - 1, chunks(a.imp.L[l - 1][kN]));
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

__global__ void __launch_bounds__(kBlockThreads, 1)
bg_sweep_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  Ctx c;
  c.T = align1024(smem_raw);
  c.a = &a;
  c.it = c.tphase = c.done = 0;
  c.cw = threadIdx.x >> 7;
  KRing ring = make_ring<kSlots>(c.slots());
  if (threadIdx.x == 0) *c.stored() = 0;
  const int row0 = blockIdx.x * kPts;
  load_rows_f32(Smem::xs(c), a.x4, a.d_in, kPts, row0, a.n, threadIdx.x,
                kBlockThreads);
  load_rows_f32(Smem::ds(c), a.dirs, 3, kPts, row0, a.n, threadIdx.x,
                kBlockThreads);
  load_rows_f32(Smem::cot(c), a.cot, kBgCot, kPts, row0, a.n, threadIdx.x,
                kBlockThreads);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      run_script(ring, a.script, a.n_items, a.w, c.stored());
    return;
  }
  consume(c);
}

}  // namespace
}  // namespace i2sdf

// `reg`, `script` and `jobs` (int64, device memory except `jobs`) are
// built by `i2sdf_tpu_torch/ops/kernels/bg_core.py::BgPlan`; the plans are
// `BgStages`' `imp` (the hidden layers, then sigma's and the features'
// products), `rad` and the transposed chains `timp` and `trad` (stage
// images in `w_t`). `jobs` (host memory) as K4's (`read_jobs`).
extern "C" int i2sdf_bg_core_bwd(
    const float* x4, const float* dirs, const float* cot, int n, int blocks,
    const void* w_imp, const float* b_imp, const int* imp_desc, int n_imp,
    const void* w_rad, const float* b_rad, const int* rad_desc, int n_rad,
    const void* w_t, const int* timp_desc, int n_timp, const int* trad_desc,
    int d_in, int fx, int fv, int F, void* scratch, float* ws32,
    const long long* reg, const long long* script, int n_items,
    const long long* jobs, int n_jobs, const long long* db_host, float* out,
    void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_imp < 3 || n_imp > kMaxLayers || n_timp != n_imp - 2 || n_rad < 1 ||
      n_rad > kMaxLayers || n_jobs > kMaxWJobs || n_imp - 1 > kRegLayers ||
      n_rad > kRegLayers || d_in < 1 || d_in > 4 || F + 1 > kWsumCols)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x4 = x4;
  a.dirs = dirs;
  a.cot = cot;
  a.n = n;
  a.w.p[0] = (const unsigned char*)scratch;
  a.w.p[1] = (const unsigned char*)w_imp;
  a.w.p[2] = (const unsigned char*)w_rad;
  a.w.p[3] = nullptr;
  a.w.p[4] = (const unsigned char*)w_t;
  a.b_imp = b_imp;
  a.b_rad = b_rad;
  a.imp = read_plan(imp_desc, n_imp);
  a.timp = read_plan(timp_desc, n_timp);
  a.rad = read_plan(rad_desc, n_rad);
  a.trad = read_plan(trad_desc, n_rad);
  a.d_in = d_in;
  a.fx = fx;
  a.fv = fv;
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
  cudaError_t err = set_smem((const void*)bg_sweep_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  bg_sweep_kernel<<<blocks, kBlockThreads, kSmemBytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_products<9>(wj, grid, sj, a.scratch, ws32, st);
}
