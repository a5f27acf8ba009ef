// The SDF net's second-order backward sweep on `wgmma_sweep.cuh`, shared
// by K4 (`render_core_bwd.cu`: with the radiance net and the light head
// around it) and K6 (`rev_bwd.cu`: the SDF net alone, its output layer's
// cotangent read from device memory): the consumers' arguments and shared
// memory, the encoding's tiles, and the SDF layers of each sweep (the
// forward recompute with its q stash, the reverse sweep, the upward sweep
// with its second-order term dz_extra = dr * ah * 100 s (1 - s), the
// downward sweep), as `sdf_forward_hidden` and `sdf_backward` call them.
// The arithmetic and its rounding are K4's (its header says how the
// sweeps run); K6 runs the same code, so the two round alike. K5
// (`rev_fwd.cu`) runs the forward and the reverse sweep of the same code
// with the template flag kGrad (`sdf_forward_hidden<true>`: no operand
// stores, q staged in f32; `rev_first<true>`, `rev_layer<W, true>`: down
// to layer 0, the encoding's share of d sdf / d PE gathered, nothing
// staged): its forward is the one K6 linearizes but for layer 0, which K5
// takes on the encoding as a hi/lo pair of bf16 tiles (`kFillPeLo`), so
// its activations are near K6's, not K6's bits; its reverse sweep reads s
// = softplus'(z) in f32, as the TPU kernel's does.
#pragma once

#include "wgmma_sweep.cuh"

namespace i2sdf {
namespace {

using namespace wg;

// ---- the sweep's consumer side --------------------------------------------

struct Args {
  const float* x;
  const float* dirs;
  const float* cot;
  const float* c_out;       // K6: the output layer's cotangent [sdf | F]
  float* out;               // K5: [sdf | features] (n, out_cols)
  float* grad;              // K5: d sdf / d x (n, 3)
  int out_cols;
  int n;
  Bases w;                 // [scratch, sdf, rad, light, transposed] blobs
  const float* b_sdf;      // K3's biases: the SDF stage chain's,
  const float* b_rad;      // the radiance chain's,
  const float* b_l;        // the light chain's
  const float* wsdf;       // ah of the output layer: W[:, sdf] (bf16)
  const float* gin;        // K4 idr: K3's d sdf / d x (n, 3), unclamped
  const float* wgr;        // K4 idr: W_rad0's gradient rows (3, bf16)
  Plan fwd, tsdf, rad, trad, light, tlight;
  int mx, md, F;
  const long long* reg;    // regions, then the bias rows' offsets
  const long long* script;
  int n_items;
  unsigned char* scratch;
};

// The consumers' state and shared memory (`SweepCtx`): after the ring,
// the points, then K4's and K6's directions, cotangents and rgb, or in
// their place K5's d sdf / d PE (`gpe`, f32, kPeStride a row).
constexpr int kRest = kPts * (3 + (3 + kCot + 8 > kPeStride
                                       ? 3 + kCot + 8 : kPeStride));
using Ctx = SweepCtx<Args, kRest>;
constexpr size_t kSmemBytes = Ctx::kSmemBytes;

struct Smem {
  static __device__ __forceinline__ float* xs(const Ctx& c) {
    return c.rest();
  }
  static __device__ __forceinline__ float* ds(const Ctx& c) {
    return xs(c) + kPts * 3;
  }
  static __device__ __forceinline__ float* cot(const Ctx& c) {
    return ds(c) + kPts * 3;
  }
  static __device__ __forceinline__ float* rgb(const Ctx& c) {
    return cot(c) + kPts * kCot;
  }
  static __device__ __forceinline__ float* gpe(const Ctx& c) {
    return ds(c);
  }
};

// T's first `ch` chunks from a region of the scratch (complete: stored
// before the last sweep_done).
__device__ __forceinline__ void load_T(Ctx& c, const unsigned char* src,
                                       int ch) {
  if (threadIdx.x == 0) {
    bulk_wait_read();
    mbar_expect_tx(c.tbar(), (uint32_t)ch * kChunkBytes);
    bulk_copy(c.T, src, (uint32_t)ch * kChunkBytes, c.tbar());
  }
  mbar_wait(c.tbar(), c.tphase);
  c.tphase ^= 1;
}

__device__ __forceinline__ float get1(const unsigned char* tile, int row,
                                      int col) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(tile + act_off(row, col)));
}

// An f32 tile of 64 rows x 256 columns in two slots, in accumulator
// order: each warp's pair of columns of its 16 rows in 256 contiguous
// bytes (8-column group j < 16 in the first slot).
__device__ __forceinline__ float2* f32_at(unsigned char* s0,
                                          unsigned char* s1, int row,
                                          int col) {
  const int j = col >> 3;
  unsigned char* base = j < 16 ? s0 : s1;
  const int idx = ((((j & 15) * 4 + (row >> 4)) * 2 + ((row >> 3) & 1)) * 32 +
                   (row & 7) * 4 + ((col >> 1) & 3));
  return reinterpret_cast<float2*>(base) + idx;
}

// Column p of dg_emb = (c_grad Sel^T) * d PE / dx: c_grad itself in the
// first three, c_grad_i f cos(f x_i) and -c_grad_i f sin(f x_i) after
// (accurate sinf / cosf, as the encoding's `pe_value`).
__device__ __forceinline__ float dge_at(const float* x3, const float* cg,
                                        int F, int p) {
  if (p < 3) return cg[p];
  int q = p - 3;
  const bool is_cos = q >= 3 * F;
  if (is_cos) q -= 3 * F;
  const int d = q / F, j = q - F * d;
  const float f = ldexpf(1.f, j), a = x3[d] * f;
  return cg[d] * (is_cos ? -f * sinf(a) : f * cosf(a));
}

enum Fill { kFillPeX, kFillPeDirs, kFillDge, kFillPeLo };

// scale * (PE(x), PE(dirs), dg_emb or PE(x)'s low half, PE - bf16(PE))
// into columns [col0, kend) of T, zero past the encoding's width: four
// threads a row.
__device__ __forceinline__ void fill_T(Ctx& c, int what, int col0, int kend,
                                       float scale) {
  const int r = threadIdx.x >> 2;
  const int F = what == kFillPeDirs ? c.a->md : c.a->mx, d0 = 3 + 6 * F;
  const float* x3 = (what == kFillPeDirs ? Smem::ds(c) : Smem::xs(c)) + 3 * r;
  for (int q = threadIdx.x & 3; q < kend - col0; q += 4) {
    float v = 0.f;
    if (q < d0) {
      v = what == kFillDge ? dge_at(x3, Smem::cot(c) + r * kCot, F, q)
                           : pe_value(x3, F, q);
      if (what == kFillPeLo) v -= __bfloat162float(__float2bfloat16_rn(v));
    }
    put1(c.T, r, col0 + q, v * scale);
  }
}

// ---- the sweeps, one layer each -------------------------------------------

// Forward recompute, hidden layer l: h into T (columns below the next
// layer's skip column, then the encoding there), q to its stash (bf16; in
// f32 over two slots in accumulator order with kGrad, K5's).
template <int NW, bool kGrad = false>
__device__ __forceinline__ void fwd_hidden(Ctx& c, float* acc, int l,
                                           const Split& sp) {
  const int* L = c.a->fwd.L[l];
  const int* nx = c.a->fwd.L[l + 1];
  product<NW>(c, acc, L, sp.col0);
  const int s = take(c);
  const int s2 = kGrad ? take(c) : -1;
  unsigned char* S = c.slot(s);
  if (sp.active) {
    const Frag f;
    const float scale = (L[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const float* b = c.a->b_sdf + L[kBOff];
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
        if constexpr (kGrad)
          *f32_at(S, c.slot(s2), f.row() + 8 * h, col) =
              make_float2(stash_q(z0), stash_q(z1));
        else
          put_pair(S, f.row() + 8 * h, col, stash_q(z0), stash_q(z1));
      }
    }
  }
  if (nx[kFlags] & kSkipIn) {
    bar_sync(1, kConsumers);
    fill_T(c, kFillPeX, nx[kCol], nx[kK], kInvSqrt2);
  }
  fence_async();
  stage_out(c, s, s2, kRegQ, l,
            kGrad ? kSlotBytes : (uint32_t)chunks(L[kN]) * kChunkBytes);
}

// Reverse sweep through W_l^T (l = ns-2 .. 1): ah_l = scale (r_l W_l^T)
// on the hidden columns, staged in f32; r_{l-1} = ah_l s_{l-1} into T.
// kGrad (K5: l = ns-2 .. 0, layer 0 the transposed chain's row ns-1):
// q read in f32 (two slots), nothing staged; the encoding's columns of
// scale (r_l W_l^T), from Lt[kCol] (a skip's, or all of layer 0's), added
// into d sdf / d PE (`Smem::gpe`, f32); layer 0 carries no r further.
template <int NW, bool kGrad = false>
__device__ __forceinline__ void rev_layer(Ctx& c, float* acc, int l,
                                          const Split& sp) {
  const int ns = c.a->fwd.n - 1;
  const int* Lt = c.a->tsdf.L[ns - 1 - l];
  product<NW>(c, acc, Lt, sp.col0);
  const bool carry = !kGrad || l > 0;
  const int sq = carry ? take(c) : 0;
  int sa = 0, sb = 0;
  if constexpr (!kGrad) {
    sa = take(c);
    sb = take(c);
  } else if (carry) {
    sa = take(c);   // q's second f32 slot
  }
  if (sp.active) {
    const Frag f;
    const float scale = (Lt[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const int n_h = Lt[kReal];
    const unsigned char* Q = c.slot(sq);
    // the encoding's columns [e0, e0 + d0) (kGrad)
    [[maybe_unused]] const int e0 = Lt[kCol];
    [[maybe_unused]] const int d0 = 3 + 6 * c.a->mx;
    [[maybe_unused]] float* gpe = Smem::gpe(c);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float a0 = col < n_h ? acc[4 * j + 2 * h] * scale : 0.f;
        const float a1 = col + 1 < n_h ? acc[4 * j + 2 * h + 1] * scale : 0.f;
        if constexpr (kGrad) {
          const int p = col - e0;
          if (p >= 0 && p < d0)
            gpe[row * kPeStride + p] += acc[4 * j + 2 * h] * scale;
          if (p + 1 >= 0 && p + 1 < d0)
            gpe[row * kPeStride + p + 1] += acc[4 * j + 2 * h + 1] * scale;
        } else {
          *f32_at(c.slot(sa), c.slot(sb), row, col) = make_float2(a0, a1);
        }
        // no branch on a value of the accumulators (ptxas would
        // serialize the wgmma): the stash is read whole, masked by select
        if (carry) {
          const float2 q = kGrad ? *f32_at(c.slot(sq), c.slot(sa), row, col)
                                 : get_pair(Q, row, col);
          put_pair(c.T, row, col, col < n_h ? a0 * stash_s(q.x) : 0.f,
                   col + 1 < n_h ? a1 * stash_s(q.y) : 0.f);
        }
      }
    }
  }
  if (carry) release(c, sq);
  if (kGrad && carry) release(c, sa);
  fence_async();
  if constexpr (kGrad)
    bar_sync(1, kConsumers);
  else
    stage_out(c, sa, sb, kRegAh, l, kSlotBytes);
}

// Upward sweep through W_l (l = 0 .. ns-2): dr = da_l W_l; on the hidden
// columns da_{l+1} = scale dr s_l into T (the encoding's share of dg_emb
// at a skip) and dz_extra_l = dr ah_{l+1} 100 s_l (1 - s_l) staged.
template <int NW, bool vec>
__device__ __forceinline__ void up_layer(Ctx& c, float* acc, int l,
                                         const Split& sp) {
  const int ns = c.a->fwd.n - 1;
  const int* L = c.a->fwd.L[l];
  const int* nx = c.a->fwd.L[l + 1 == ns - 1 ? ns : l + 1];
  product<NW>(c, acc, L, sp.col0);
  // vec: the last hidden layer, ah_{ns-1} = W_{ns-1}[:, sdf]
  const int sq = take(c);
  int sa = -1, sb = -1;
  if constexpr (!vec) {
    sa = take(c);
    sb = take(c);
  }
  const int ss = take(c);
  if (sp.active) {
    const Frag f;
    const float scale = (L[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const int n_h = L[kReal];
    const unsigned char* Q = c.slot(sq);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float2 q = get_pair(Q, row, col);
        float2 ah;
        if constexpr (vec)
          ah = *reinterpret_cast<const float2*>(c.a->wsdf + col);
        else
          ah = *f32_at(c.slot(sa), c.slot(sb), row, col);
        const float r0 = acc[4 * j + 2 * h], r1 = acc[4 * j + 2 * h + 1];
        const bool k0 = col < n_h, k1 = col + 1 < n_h;
        put_pair(c.T, row, col, k0 ? r0 * stash_s(q.x) * scale : 0.f,
                 k1 ? r1 * stash_s(q.y) * scale : 0.f);
        put_pair(c.slot(ss), row, col,
                 k0 ? r0 * ah.x * stash_d2(q.x) : 0.f,
                 k1 ? r1 * ah.y * stash_d2(q.y) : 0.f);
      }
    }
  }
  release(c, sq);
  if constexpr (!vec) {
    release(c, sa);
    release(c, sb);
  }
  if (nx[kFlags] & kSkipIn) {
    bar_sync(1, kConsumers);
    fill_T(c, kFillDge, nx[kCol], nx[kK], kInvSqrt2);
  }
  fence_async();
  stage_out(c, ss, -1, kRegDzx, l, (uint32_t)chunks(L[kN]) * kChunkBytes);
}

// Downward sweep through W_l^T (l = ns-1 .. 1): on the hidden columns
// dz_{l-1} = scale (dz_l W_l^T) s_{l-1} + dz_extra_{l-1} into T; its bias
// row.
template <int NW>
__device__ __forceinline__ void down_layer(Ctx& c, float* acc, int l,
                                           const Split& sp) {
  const int ns = c.a->fwd.n - 1;
  const int* Lt = c.a->tsdf.L[ns - 1 - l];
  product<NW>(c, acc, Lt, sp.col0);
  const int sq = take(c), sz = take(c);
  if (sp.active) {
    const Frag f;
    const float scale = (Lt[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const int n_h = Lt[kReal];
    const unsigned char* Q = c.slot(sq);
    const unsigned char* Z = c.slot(sz);
    float v[4];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float2 q = get_pair(Q, row, col);
        const float2 x = get_pair(Z, row, col);
        v[2 * h] = col < n_h
                       ? acc[4 * j + 2 * h] * scale * stash_s(q.x) + x.x
                       : 0.f;
        v[2 * h + 1] =
            col + 1 < n_h
                ? acc[4 * j + 2 * h + 1] * scale * stash_s(q.y) + x.y
                : 0.f;
        put_pair(c.T, row, col, v[2 * h], v[2 * h + 1]);
      }
      col_sums(c.wsum(), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  release(c, sq);
  release(c, sz);
  bias_row(c, c.db_off(l - 1), c.a->fwd.L[l - 1][kReal]);
  fence_async();
  bar_sync(1, kConsumers);
}

// The reverse sweep's start: r_{ns-2} = ah_{ns-1} s_{ns-2} into T, with
// ah_{ns-1} = W_{ns-1}[:, sdf], once T's bulk store has read it (kGrad:
// q in f32 over two slots).
template <bool kGrad = false>
__device__ __forceinline__ void rev_first(Ctx& c) {
  const Args& a = *c.a;
  const int ns = a.fwd.n - 1;
  const int sq = take(c);
  const int sq2 = kGrad ? take(c) : 0;
  wait_T(c);
  const int* L = a.fwd.L[ns - 2];
  const int n_h = L[kReal], N = 64 * chunks(L[kN]);
  const unsigned char* Q = c.slot(sq);
  for (int i = threadIdx.x; i < kPts * N; i += kConsumers) {
    const int r = i / N, col = i % N;
    const float q =
        kGrad ? reinterpret_cast<const float*>(
                    f32_at(c.slot(sq), c.slot(sq2), r, col & ~1))[col & 1]
              : get1(Q, r, col);
    put1(c.T, r, col, col < n_h ? a.wsdf[col] * stash_s(q) : 0.f);
  }
  release(c, sq);
  if (kGrad) release(c, sq2);
  fence_async();
  bar_sync(1, kConsumers);
}

// The forward recompute's hidden layers: PE(x) into T, then each hidden
// layer's input X_l stored (the weight gradients' operand; K5, kGrad,
// stores none), h_l into T and q_l staged. T then holds the output
// layer's input, not yet stored. kGrad: layer 0 reads the encoding as a
// hi/lo pair, bf16(PE) in T's first chunk and PE - bf16(PE) from column
// 64 (its depth K in K5's plan 64 + the encoding's padded width, the ring
// bringing W_0's stages twice): z_0 misses PE's rounding, which the
// encoding's high frequencies carry into the gradient.
template <bool kGrad = false>
__device__ __forceinline__ void sdf_forward_hidden(Ctx& c, float* acc) {
  const Args& a = *c.a;
  const int ns = a.fwd.n - 1;
  if constexpr (kGrad) {
    fill_T(c, kFillPeX, 0, 64, 1.f);
    fill_T(c, kFillPeLo, 64, a.fwd.L[0][kK], 1.f);
  } else {
    fill_T(c, kFillPeX, 0, a.fwd.L[0][kK], 1.f);
  }
  fence_async();
  bar_sync(1, kConsumers);
  for (int l = 0; l < ns - 1; ++l) {
    if constexpr (!kGrad) store_T(c, kRegX, l, chunks(a.fwd.L[l][kK]));
    const Split sp(a.fwd.L[l][kN], c.cw);
#define CALL(W) fwd_hidden<W, kGrad>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
}

// The reverse, upward and downward sweeps, once the SDF output layer's
// cotangent (kernel order [features | sdf]) has been stored (`kRegDz`,
// layer ns-1) with its bias row and the forward's sweeps are done.
__device__ __forceinline__ void sdf_backward(Ctx& c, float* acc) {
  const Args& a = *c.a;
  const int ns = a.fwd.n - 1, F = a.F;
  const int out_k = a.tsdf.L[0][kK];   // the output layer's padded width

  // ---- 4. reverse sweep: r_l stored, ah_l staged ------------------------
  wait_T(c);
  for (int i = threadIdx.x; i < kPts * 64 * chunks(out_k); i += kConsumers) {
    const int w = 64 * chunks(out_k), r = i / w, col = i % w;
    put1(c.T, r, col, col == F ? 1.f : 0.f);
  }
  fence_async();
  bar_sync(1, kConsumers);
  store_T(c, kRegR, ns - 1, chunks(out_k));
  rev_first(c);
  for (int l = ns - 2; l >= 1; --l) {
    store_T(c, kRegR, l, chunks(a.fwd.L[l][kN]));
    const Split sp(a.tsdf.L[ns - 1 - l][kN], c.cw);
#define CALL(W) rev_layer<W>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  store_T(c, kRegR, 0, chunks(a.fwd.L[0][kN]));
  sweep_done(c);

  // ---- 5-6. upward sweep: da_l stored, dz_extra_l staged -----------------
  wait_T(c);
  fill_T(c, kFillDge, 0, 64 * chunks(a.fwd.L[0][kK]), 1.f);
  fence_async();
  bar_sync(1, kConsumers);
  for (int l = 0; l < ns - 1; ++l) {
    store_T(c, kRegDa, l, chunks(a.fwd.L[l][kK]));
    const Split sp(a.fwd.L[l][kN], c.cw);
    if (l < ns - 2) {
#define CALL(W) up_layer<W, false>(c, acc, l, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    } else {
#define CALL(W) up_layer<W, true>(c, acc, l, sp)
      I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
    }
  }
  store_T(c, kRegDa, ns - 1, chunks(a.fwd.L[ns][kK]));
  sweep_done(c);

  // ---- 7. downward sweep: dz_l stored, bias rows --------------------------
  load_T(c, c.region(kRegDz, ns - 1), chunks(out_k));
  for (int l = ns - 1; l >= 1; --l) {
    if (l < ns - 1) store_T(c, kRegDz, l, chunks(a.fwd.L[l][kN]));
    const Split sp(a.tsdf.L[ns - 1 - l][kN], c.cw);
#define CALL(W) down_layer<W>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
  store_T(c, kRegDz, 0, chunks(a.fwd.L[0][kN]));
  if (threadIdx.x == 0) bulk_wait_all();
}

}  // namespace
}  // namespace i2sdf
