// K4 render_core_bwd: the backward of the render core (SDF, its spatial
// gradient and the radiance at a batch of points, and with the light-mask
// config's light head the light mask): the gradients of
// <cot, [grad | sdf | rgb | lmask]> with respect to every weight and bias
// of the SDF, radiance and light nets, second-order terms included.
//
// Replaces the backward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_train.py:449 get_render_core_op` (pallas_call at :609, body
// `_make_bwd_kernel` at :267-446, the light head at :324-348), reached
// through the custom-VJP render core of the training step
// (`i2sdf_tpu/models/renderer.py:345-377`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs ~7.6 M bf16 flops at the nets' real widths (the forward
// recompute, the radiance backward, the reverse, upward and downward
// sweeps and the weight-gradient products; `chip_smoke.py::k4_macs`)
// against 52 bytes in.
//
// Design: two launches and the fixed-order sums, on `wgmma_layer.cuh`; the
// SDF net's sweeps (`sdf_forward_hidden`, `sdf_backward` and their layers)
// live in `sdf_sweep.cuh`, which K6 (`rev_bwd.cu`) runs too.
//
// 1. `k4_sweep_kernel<kLight, kCoupled>`: 64 points a block, one 64-row activation tile T
//    (five 64-column chunks) in shared memory, two consumer warpgroups
//    that split each layer's columns and a producer warp. Every sweep is
//    a wgmma product of T with a layer's weights, W (stage images of W^T,
//    K3's `CoreStages`) or W^T (stage images of W, `K4Stages`: a
//    transposed product reduces over the other dimension, so K3's images,
//    64-deep chunks of K, cannot feed it without a whole layer resident),
//    written in place after both warpgroups retire: the forward
//    recompute (the features product, not the sdf), the light head, the
//    radiance forward and backward, the reverse sweep (d sdf / d h), the
//    upward sweep with its second-order term dz_extra = dr * ah * 100 s
//    (1 - s), and the downward sweep. A layer's stash does not fit beside
//    the ring (eight hidden layers' q at 64 rows are 256 KB), so the
//    stash leaves the block: the epilogue writes q = `stash_q(z)`, ah
//    (f32) or dz_extra into a ring slot the producer handed out empty
//    (a staging slot), one thread bulk-copies it to this block's region
//    of the scratch, and the producer brings it back as a ring stage in
//    the order the sweeps take it. The producer walks a table the host
//    builds (`render_core.K4Plan.script`): weight stages, stash tiles,
//    staging slots, and waits until the consumers' stores of an earlier
//    sweep are complete (`stored`). Before each product the tile T, the
//    layer's weight-gradient operand (X, dz, da, r of an SDF layer; the
//    input and dz of a radiance or light layer), is bulk-copied to the
//    block's operand region as it sits: 64-row chunks in the 128-byte
//    swizzle. The bias gradients are summed in f32 over the block's rows
//    in a fixed order (warp shuffles, then four warps in order) into the
//    block's bias row.
// 2. `wgrad_kernel<4>` (`wgmma_sweep.cuh`, K9's too): every dW = A^T B
//    over the points (SDF layers: X^T dz + da^T r; radiance and light
//    layers X^T dz) on wgmma with both operands MN-major (the transpose
//    bits), read straight from the operand regions the sweep wrote: a
//    block takes 128 rows of dW (two A chunks, one a warpgroup) by 256
//    columns (four B chunks) over one range of points, the producer
//    bulk-copying each 64-point block's chunks into a four-slot ring; the
//    partial sums go to device memory.
// 3. `sum_kernel` (common.cuh): the ranges' partial sums and the blocks'
//    bias rows added in a fixed order, so the result does not change from
//    run to run.
//
// The activation derivative is stashed as q (`stash_q`), so 100 s (1 - s)
// keeps bf16's relative precision. The forward recompute's activations,
// rgb, the light mask and the encoding take the accurate expf, log1pf,
// sinf and cosf (common.cuh), as the plain op and the reference do, so
// the kernel rounds where its replay (tests/test_torch_bwd_replay.py)
// rounds. The encoding's Jacobian is the closed
// form (d sin(f x)/dx = f cos(f x)). Eikonal rows carry zero directions
// and zero rgb, sdf and light cotangents; padding rows all-zero
// cotangents, so every weight-gradient pair has a zero side there and
// they add nothing.
//
// The light head (`kLight`, c_lm the cotangents' column 7; `kCoupled`
// with `detach_light` off) runs after the SDF recompute: the features go to the radiance input's operand region,
// relu(features) through the light net (each hidden layer's s =
// sigmoid(100 z) staged), its backward, and with `detach_light` off the
// light net's input cotangent gated by relu'(features), staged in f32;
// then the features come back into T and the radiance net runs, its
// feature cotangent joined by the light's in f32 before the SDF output
// layer's cotangent is stored.
//
// The idr-mode radiance net (the TPU op's `idr` branch,
// `fused_train.py:199-218,355-366`; `gin` not null) takes [features |
// PE(dirs) | xyz | d sdf / d x]: the gradient is the one K3 gave the
// same points (`gin`, unclamped; the wrapper keeps K3's output), written
// as bf16 beside the raw xyz after PE(dirs), so the radiance forward runs
// before any sweep of the SDF net has given it. The radiance input's
// cotangent on the gradient's three columns, dz_0 W_rad0[grad rows]^T
// (`wgr`, bf16 rounded, summed in f32 from T's bf16 dz_0 before the
// feature product's result replaces it), joins the external c_grad in
// shared memory, which the upward sweep's dg_emb reads after the radiance
// backward: every render row then carries a gradient cotangent. The two
// steps branch on `gin`, uniform over the block, outside every sweep's
// loop: a template flag would compile the whole sweep once more (K4's
// source sets the build's length).
//
// The light head beside idr (the TPU kernel's `n_l` with `idr`,
// `fused_train.py:267-446`) is the light sweep on the idr branch, in
// this order: the light head borrows the radiance input's operand region
// and gives T's feature chunks back (it touches no column past the
// features), and only then do PE(dirs) and the idr columns go into T, so
// neither overwrites the other; the radiance forward then stores the
// whole input over the region. With `detach_light` off the two
// cotangents into the SDF output layer keep their own staging: the
// light's gated feature cotangent in the scratch (`kRegClg`, read back
// into c_feat), idr's gradient-column cotangent summed into c_grad in
// shared memory (`Smem::cot`), which the upward sweep reads. The shared
// memory is K4-light's: idr adds no staging of its own.
#include "sdf_sweep.cuh"

namespace i2sdf {
namespace {

// Forward recompute, the output layer's feature columns into T.
template <int NW>
__device__ __forceinline__ void fwd_features(Ctx& c, float* acc, const int* L,
                                             const Split& sp) {
  product<NW>(c, acc, L, sp.col0);
  if (sp.active) {
    const Frag f;
    const float* b = c.a->b_sdf + L[kBOff];
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

enum NetKind { kNetRad = 0, kNetLight = 1 };

// A radiance or light layer forward: a hidden layer's activation into T
// (relu; the light net's softplus100, its s to the stash), the radiance
// net's last layer's rgb to shared memory, the light net's last layer's
// dz = c_lm lm (1 - lm) into T.
template <int NW, int kNet, bool last>
__device__ __forceinline__ void net_fwd(Ctx& c, float* acc, int l,
                                        const Split& sp) {
  const Plan& P = kNet == kNetRad ? c.a->rad : c.a->light;
  const int* L = P.L[l];
  const float* b = (kNet == kNetRad ? c.a->b_rad : c.a->b_l) + L[kBOff];
  product<NW>(c, acc, L, sp.col0);
  constexpr bool stage = kNet == kNetLight && !last;
  int s = -1;
  if constexpr (stage) s = take(c);
  if (sp.active) {
    const Frag f;
    float v[4];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float z0 = acc[4 * j + 2 * h] + bb.x;
        const float z1 = acc[4 * j + 2 * h + 1] + bb.y;
        if constexpr (!last && kNet == kNetRad) {
          put_pair(c.T, row, col, fmaxf(z0, 0.f), fmaxf(z1, 0.f));
        } else if constexpr (!last) {
          put_pair(c.T, row, col, softplus100(z0), softplus100(z1));
          put_pair(c.slot(s), row, col, dsoftplus100(z0),
                   dsoftplus100(z1));
        } else if constexpr (kNet == kNetRad) {
          // all eight columns of the N = 8 product, the real ones first
          *reinterpret_cast<float2*>(Smem::rgb(c) + row * 8 + col) =
              make_float2(1.f / (1.f + expf(-z0)), 1.f / (1.f + expf(-z1)));
        } else {
          const float lm = 1.f / (1.f + expf(-z0));
          v[2 * h] =
              col == 0 ? Smem::cot(c)[row * kCot + 7] * lm * (1.f - lm) : 0.f;
          v[2 * h + 1] = 0.f;
          put_pair(c.T, row, col, v[2 * h], 0.f);
        }
      }
      if constexpr (last && kNet == kNetLight)
        col_sums(c.wsum(), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  if constexpr (last && kNet == kNetLight) {
    // the light net's dz: zero past the product's columns, its bias row
    for (int i = threadIdx.x; i < kPts * (64 - L[kN]); i += kConsumers)
      put1(c.T, i / (64 - L[kN]), L[kN] + i % (64 - L[kN]), 0.f);
    bias_row(c, c.db_off(c.a->fwd.n - 1 + c.a->rad.n + l), L[kReal]);
  }
  fence_async();
  if constexpr (stage)
    stage_out(c, s, -1, kRegLs, l, (uint32_t)chunks(L[kN]) * kChunkBytes);
  else
    bar_sync(1, kConsumers);
}

// A radiance or light layer backward (l >= 1): dz_{l-1} = (dz_l W_l^T) *
// the mask (relu'(input of layer l), from its operand) or s (the light
// net's stash) into T; its bias row.
template <int NW, int kNet>
__device__ __forceinline__ void net_bwd(Ctx& c, float* acc, int l,
                                        const Split& sp) {
  const Plan& P = kNet == kNetRad ? c.a->rad : c.a->light;
  const Plan& PT = kNet == kNetRad ? c.a->trad : c.a->tlight;
  const int* Lt = PT.L[P.n - 1 - l];
  product<NW>(c, acc, Lt, sp.col0);
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
        const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
        v[2 * h] = kNet == kNetRad ? (m.x > 0.f ? d0 : 0.f) : d0 * m.x;
        v[2 * h + 1] = kNet == kNetRad ? (m.y > 0.f ? d1 : 0.f) : d1 * m.y;
        put_pair(c.T, row, col, v[2 * h], v[2 * h + 1]);
      }
      col_sums(c.wsum(), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  release(c, s);
  const int base =
      kNet == kNetRad ? c.a->fwd.n - 1 : c.a->fwd.n - 1 + c.a->rad.n;
  bias_row(c, c.db_off(base + l - 1), P.L[l - 1][kReal]);
  fence_async();
  bar_sync(1, kConsumers);
}

// The radiance net's first layer backward: c_feat = dz_0 W_0^T on the
// feature columns (with the light head coupled, plus its staged gated
// cotangent), then the SDF output layer's cotangent [c_feat | c_sdf | 0]
// into T and its bias row.
template <int NW, bool kCoupled>
__device__ __forceinline__ void rad_first_bwd(Ctx& c, float* acc,
                                              const Split& sp) {
  constexpr bool coupled = kCoupled;
  const int* Lt = c.a->trad.L[c.a->rad.n - 1];
  const int F = c.a->F;
  product<NW>(c, acc, Lt, sp.col0);
  if (c.a->gin != nullptr) {
    // T still holds dz_0 (bf16): the gradient columns' cotangent, a
    // point's three sums a thread, into c_grad
    const int n0 = c.a->rad.L[0][kN], ws = 64 * chunks(n0);
    for (int i = threadIdx.x; i < kPts * 3; i += kConsumers) {
      const int r = i / 3, j = i - 3 * r;
      const float* w = c.a->wgr + j * ws;
      float s = 0.f;
      for (int k = 0; k < n0; ++k) s += get1(c.T, r, k) * w[k];
      Smem::cot(c)[r * kCot + j] += s;
    }
    bar_sync(1, kConsumers);
  }
  int sa = -1, sb = -1;
  if constexpr (coupled) {
    sa = take(c);
    sb = take(c);
  }
  if (sp.active) {
    const Frag f;
    float v[4];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        v[2 * h] = acc[4 * j + 2 * h];
        v[2 * h + 1] = acc[4 * j + 2 * h + 1];
        if constexpr (coupled) {
          const float2 g = *f32_at(c.slot(sa), c.slot(sb), row, col);
          v[2 * h] += g.x;
          v[2 * h + 1] += g.y;
        }
        put_pair(c.T, row, col, v[2 * h], v[2 * h + 1]);
      }
      col_sums(c.wsum(), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  if constexpr (coupled) {
    release(c, sa);
    release(c, sb);
  }
  // the sdf column carries c_sdf; the padding columns are zero (written
  // after the product's columns past F)
  bar_sync(1, kConsumers);
  for (int i = threadIdx.x; i < kPts * (kTChunks * 64 - F); i += kConsumers) {
    const int r = i / (kTChunks * 64 - F), col = F + i % (kTChunks * 64 - F);
    put1(c.T, r, col, col == F ? Smem::cot(c)[r * kCot + 3] : 0.f);
  }
  const int ns = c.a->fwd.n - 1;   // the SDF net's layers (fwd has the
                                   // sdf tile and the features apart)
  bias_row(c, c.db_off(ns - 1), F);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < kPts; ++r) s += Smem::cot(c)[r * kCot + 3];
    c.dbrow()[c.db_off(ns - 1) + F] = s;
  }
  fence_async();
  bar_sync(1, kConsumers);
}



// With `detach_light` off: the light net's input cotangent dz_0 W_0^T on
// the feature columns, gated by relu'(features) (its input, the operand
// lx_0, brought back), staged in f32.
template <int NW>
__device__ __forceinline__ void light_input_cot(Ctx& c, float* acc,
                                                const int* Lt,
                                                const Split& sp) {
  product<NW>(c, acc, Lt, sp.col0);
  const int sx = take(c), sa = take(c), sb = take(c);
  if (sp.active) {
    const Frag f;
    const unsigned char* X = c.slot(sx);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float2 m = get_pair(X, row, col);
        *f32_at(c.slot(sa), c.slot(sb), row, col) =
            make_float2(m.x > 0.f ? acc[4 * j + 2 * h] : 0.f,
                        m.y > 0.f ? acc[4 * j + 2 * h + 1] : 0.f);
      }
    }
  }
  release(c, sx);
  fence_async();
  stage_out(c, sa, sb, kRegClg, 0, kSlotBytes);
}

// The light head (after the SDF recompute; T holds the features): their
// operand region first (the radiance input's), relu(features) through the
// light net, its backward, and with `detach_light` off its input
// cotangent gated by relu'(features) staged; the features back into T.
template <bool kLight, bool kCoupled>
__device__ __forceinline__ void light_head(Ctx& c, float* acc) {
  if constexpr (kLight) {
    const Args& a = *c.a;
    const int F = a.F, nl = a.light.n;
    store_T(c, kRegRx, 0, chunks(F));
    wait_T(c);
    const int k0 = a.light.L[0][kK];
    for (int i = threadIdx.x; i < kPts * k0; i += kConsumers) {
      const int r = i / k0, col = i % k0;
      put1(c.T, r, col, col < F ? fmaxf(get1(c.T, r, col), 0.f) : 0.f);
    }
    fence_async();
    bar_sync(1, kConsumers);
    for (int l = 0; l < nl; ++l) {
      const int* L = a.light.L[l];
      store_T(c, kRegLx, l, chunks(L[kK]));
      const Split sp(L[kN], c.cw);
      if (l < nl - 1) {
#define CALL(W) net_fwd<W, kNetLight, false>(c, acc, l, sp)
        I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
      } else {
#define CALL(W) net_fwd<W, kNetLight, true>(c, acc, l, sp)
        I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
      }
    }
    sweep_done(c);
    for (int l = nl - 1; l >= 1; --l) {
      store_T(c, kRegLdz, l, chunks(a.light.L[l][kN]));
      const Split sp(a.tlight.L[nl - 1 - l][kN], c.cw);
#define CALL(W) net_bwd<W, kNetLight>(c, acc, l, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    }
    store_T(c, kRegLdz, 0, chunks(a.light.L[0][kN]));
    if constexpr (kCoupled) {
      const int* Lt = a.tlight.L[nl - 1];
      const Split sp(Lt[kN], c.cw);
#define CALL(W) light_input_cot<W>(c, acc, Lt, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    }
    sweep_done(c);
    load_T(c, c.region(kRegRx, 0), chunks(F));
  }
}

template <bool kLight, bool kCoupled>
__device__ __forceinline__ void consume(Ctx& c) {
  const Args& a = *c.a;
  // one accumulator array for every product of the kernel (a warpgroup's
  // N <= 128 half of a layer): fresh arrays a layer made ptxas serialize
  // the wgmma
  float acc[64];
  const int ns = a.fwd.n - 1, nr = a.rad.n, F = a.F;
  const int out_k = a.tsdf.L[0][kK];   // the output layer's padded width

  // ---- 1. SDF forward: X_l stored, q_l staged; the features into T ------
  sdf_forward_hidden(c, acc);
  {
    const int* L = a.fwd.L[ns];
    store_T(c, kRegX, ns - 1, chunks(L[kK]));
    const Split sp(L[kN], c.cw);
#define CALL(W) fwd_features<W>(c, acc, L, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  sweep_done(c);

  // ---- 1b. the light head ---------------------------------------------------
  light_head<kLight, kCoupled>(c, acc);

  // ---- 2. radiance forward: its inputs stored, rgb to shared memory ------
  fill_T(c, kFillPeDirs, F, a.rad.L[0][kK], 1.f);
  if (a.gin != nullptr) {
    // bf16 xyz and K3's gradient after PE(dirs)
    const int c0 = F + 3 + 6 * a.md, row0 = blockIdx.x * kPts;
    bar_sync(1, kConsumers);
    for (int i = threadIdx.x; i < kPts * 6; i += kConsumers) {
      const int r = i / 6, j = i - 6 * r;
      float v = 0.f;
      if (j < 3)
        v = Smem::xs(c)[3 * r + j];
      else if (row0 + r < a.n)
        v = a.gin[(size_t)(row0 + r) * 3 + j - 3];
      put1(c.T, r, c0 + j, v);
    }
  }
  fence_async();
  bar_sync(1, kConsumers);
  for (int l = 0; l < nr; ++l) {
    store_T(c, kRegRx, l, chunks(a.rad.L[l][kK]));
    const Split sp(a.rad.L[l][kN], c.cw);
    if (l < nr - 1) {
#define CALL(W) net_fwd<W, kNetRad, false>(c, acc, l, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    } else {
#define CALL(W) net_fwd<W, kNetRad, true>(c, acc, l, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    }
  }
  sweep_done(c);

  // ---- 3. radiance backward -------------------------------------------------
  {
    const int d_out = a.rad.L[nr - 1][kReal];
    for (int i = threadIdx.x; i < kPts * 64; i += kConsumers) {
      const int r = i >> 6, col = i & 63;
      float v = 0.f;
      if (col < d_out) {
        const float g = Smem::rgb(c)[r * 8 + col];
        v = Smem::cot(c)[r * kCot + 4 + col] * g * (1.f - g);
      }
      put1(c.T, r, col, v);
    }
    if (threadIdx.x < d_out) {
      const int k = threadIdx.x;
      float s = 0.f;
      for (int r = 0; r < kPts; ++r) {
        const float g = Smem::rgb(c)[r * 8 + k];
        s += Smem::cot(c)[r * kCot + 4 + k] * g * (1.f - g);
      }
      c.dbrow()[c.db_off(ns + nr - 1) + k] = s;
    }
    fence_async();
    bar_sync(1, kConsumers);
  }
  for (int l = nr - 1; l >= 1; --l) {
    store_T(c, kRegRdz, l, chunks(a.rad.L[l][kN]));
    const Split sp(a.trad.L[nr - 1 - l][kN], c.cw);
#define CALL(W) net_bwd<W, kNetRad>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  store_T(c, kRegRdz, 0, chunks(a.rad.L[0][kN]));
  {
    const Split sp(a.trad.L[nr - 1][kN], c.cw);
#define CALL(W) rad_first_bwd<W, kCoupled>(c, acc, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  store_T(c, kRegDz, ns - 1, chunks(out_k));
  sdf_backward(c, acc);
}

template <bool kLight, bool kCoupled>
__global__ void __launch_bounds__(kBlockThreads, 1)
k4_sweep_kernel(const __grid_constant__ Args a) {
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
  float* ds = Smem::ds(c);
  float* cot = Smem::cot(c);
  for (int i = threadIdx.x; i < kPts * 3; i += kBlockThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < a.n ? a.x[(size_t)r * 3 + i % 3] : 0.f;
    ds[i] = r < a.n ? a.dirs[(size_t)r * 3 + i % 3] : 0.f;
  }
  for (int i = threadIdx.x; i < kPts * kCot; i += kBlockThreads) {
    const int r = row0 + i / kCot;
    cot[i] = r < a.n ? a.cot[(size_t)r * kCot + i % kCot] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      run_script(ring, a.script, a.n_items, a.w, c.stored());
    return;
  }
  consume<kLight, kCoupled>(c);
}


template <bool kLight, bool kCoupled>
cudaError_t launch(const Args& a, int blocks, const WJobs& jobs, int grid,
                   const SumJobs& sums, float* ws32, cudaStream_t st) {
  cudaError_t err = set_smem(
      (const void*)k4_sweep_kernel<kLight, kCoupled>, kSmemBytes);
  if (err != cudaSuccess) return err;
  k4_sweep_kernel<kLight, kCoupled>
      <<<blocks, kBlockThreads, kSmemBytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_products<4>(jobs, grid, sums, a.scratch, ws32, st);
}

}  // namespace
}  // namespace i2sdf

// `reg`, `script` and `jobs` (int64, device memory except `jobs`) are
// built by `i2sdf_tpu_torch/ops/kernels/render_core.py::K4Plan`; the
// plans are K3's `CoreStages` (sdf, radiance, light) and `K4Stages`'
// transposed chains (their row counts 0 without a light head). `gin` and
// `wgr` (device memory, null unless idr): K3's unclamped gradient (n, 3)
// and `K4Stages.wgr` (3 rows of 64 * ceil(N_0 / 64) floats). `jobs`
// (host memory): n_jobs rows of 18 int64 (`WJob`'s fields in order),
// then each job's out offset; the sums add job p's partials into out and
// the blocks' bias rows (`reg`'s) after them.
extern "C" int i2sdf_render_core_bwd(
    const float* x, const float* dirs, const float* cot, int n, int blocks,
    const void* w_sdf, const float* b_sdf, const int* fwd_desc, int n_fwd,
    const void* w_rad, const float* b_rad, const int* rad_desc, int n_rad,
    const void* w_l, const float* b_l, const int* l_desc, int n_l,
    const void* w_t, const int* tsdf_desc, int n_tsdf, const int* trad_desc,
    const int* tl_desc, const float* wsdf, int detach_light, int mx, int md,
    int F, const float* gin, const float* wgr, void* scratch, float* ws32,
    const long long* reg, const long long* script, int n_items,
    const long long* jobs, int n_jobs,
    const long long* db_host, float* out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd < 3 || n_fwd > kMaxLayers || n_tsdf != n_fwd - 2 ||
      n_rad < 1 || n_rad > kMaxLayers || n_l < 0 || n_l > kMaxLayers ||
      n_jobs > kMaxWJobs || n_fwd - 1 > kRegLayers || n_rad > kRegLayers ||
      3 + 6 * mx > 64 || 3 + 6 * md > 64 ||
      (gin != nullptr) != (wgr != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dirs = dirs;
  a.cot = cot;
  a.n = n;
  a.w.p[0] = (const unsigned char*)scratch;
  a.w.p[1] = (const unsigned char*)w_sdf;
  a.w.p[2] = (const unsigned char*)w_rad;
  a.w.p[3] = (const unsigned char*)w_l;
  a.w.p[4] = (const unsigned char*)w_t;
  a.b_sdf = b_sdf;
  a.b_rad = b_rad;
  a.b_l = b_l;
  a.wsdf = wsdf;
  a.gin = gin;
  a.wgr = wgr;
  a.fwd = read_plan(fwd_desc, n_fwd);
  a.tsdf = read_plan(tsdf_desc, n_tsdf);
  a.rad = read_plan(rad_desc, n_rad);
  a.trad = read_plan(trad_desc, n_rad);
  // idr: the radiance input's 6 columns after PE(dirs) inside T's 5 chunks
  if (gin != nullptr && F + 3 + 6 * md + 6 > a.rad.L[0][kK])
    return (int)cudaErrorInvalidValue;
  a.light = read_plan(l_desc, n_l);
  a.tlight = read_plan(tl_desc, n_l);
  a.mx = mx;
  a.md = md;
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
  if (n_l > 0 && !detach_light)
    return (int)launch<true, true>(a, blocks, wj, grid, sj, ws32, st);
  if (n_l > 0)
    return (int)launch<true, false>(a, blocks, wj, grid, sj, ws32, st);
  return (int)launch<false, false>(a, blocks, wj, grid, sj, ws32, st);
}
