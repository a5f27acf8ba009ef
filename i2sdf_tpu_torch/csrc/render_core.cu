// K3 render_core_fwd: SDF, its spatial gradient and the radiance at a batch
// of points along their view directions (the eval forward of the render),
// and with the light-mask config's light head the light mask.
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_train.py:449 get_render_core_op` (pallas_call at :555), reached
// through `render_core_fused` (`fused_train.py:707`), the eval forward at
// `i2sdf_tpu/models/renderer.py:321-334`; the light head is the TPU op's
// `lcfg` branch (`fused_train.py:173-195,252-256`).
//
// What bounds it on the H100: operations. The function's least work at
// the flagship config is the SDF forward with its 257-wide head, the
// reverse sweep of d sdf / d x and the radiance net, ~1.27 M multiply-adds
// a point, against 24 bytes in and 28 out. This kernel's tangent form
// does more (the three tangents through every hidden layer, and the
// radiance net on half an m64 tile), ~2.2 M a point.
//
// Design (`wgmma_layer.cuh`; the tangent form `tangent_form.cuh`, which
// K10 runs too): a block of 32 points carries four streams a point, the
// activations and the three spatial tangents, as 128 rows in two m64
// tiles, and two consumer warpgroups take each hidden layer in place
// (`tangent_hidden`), with nothing stashed for a reverse sweep. The
// encoding and its analytic tangents are computed once into an f32 cache
// (PE(dirs) too) and written from it at layer 0 and, scaled by 1/sqrt(2),
// at the skip.
// The output layer's columns are permuted host-side to [features | sdf]:
// the features are an N = 256 product over tile 0, the sdf an N = 8
// product over both tiles, whose tangent rows give d sdf / d x. The
// radiance net runs on tile 0 on [features | PE(dirs)] (K padded to
// 288): its primal rows are the 32 points, the t_x rows ride along and
// are discarded. With the light head (`kLight`), relu(features) goes to
// tile 1's primal rows, where the light net (Softplus(100) hidden layers,
// a sigmoid output) runs after the radiance net. With the idr-mode
// radiance net (`kIdr`, the TPU op's `idr` branch, `fused_train.py:199-218`)
// the radiance input is [features | PE(dirs) | xyz | d sdf / d x]: the
// sdf product's tangent rows already hold the gradient, so the threads
// that hold it write it (unclamped, bf16) into the tile's columns after
// PE(dirs), and the raw xyz go beside it from the encoding's cache; K
// stays within the tile's 320 columns (289 at the flagship's widths).
// Both together (`kLight` and `kIdr`, the light-mask config with VolSDF's
// DTU radiance net) keep apart: the light input is tile 1's primal rows
// (relu(features), zero from F up to the light net's K, at most 256
// columns), the idr columns tile 0's (F + dd .. F + dd + 5, past the
// features), and the light net runs after the radiance net is done with
// tile 0; the shared memory is the same as either alone.
// The block streams every layer's stage images through the ring (a
// producer warp issues them). Only sdf, grad, rgb (and the mask) reach
// device memory.
#include "tangent_form.cuh"

namespace i2sdf {
namespace {

using namespace wg;

constexpr int kTile0Bytes = 5 * kChunkBytes;  // 64 rows x 320 columns
constexpr int kTile1Bytes = 4 * kChunkBytes;  // 64 rows x 256 columns
// the points' and directions' coordinates, their encodings and the
// encoding's three tangents, cached in f32
constexpr int kCacheFloats = 2 * kPoints * 3 + 5 * kPoints * kPeStride;
constexpr size_t kSmemBytes = 1024 + kTile0Bytes + kTile1Bytes + kRingBytes +
                              kCacheFloats * sizeof(float);

// The SDF output layer: the sdf tile (`Ls`, N = 8) over both tiles (into
// the heads of a0 and a1: an accumulator fragment at an offset into an
// array made ptxas serialize every wgmma of the kernel), sdf and
// d sdf / d x from it to device memory (the first warpgroup's; with kIdr
// also into tile 0's primal rows after PE(dirs), columns F + dd + 3..5,
// a chunk no SDF product reads); then this
// warpgroup's NW feature columns (`Lf`) over tile 0 (a0), the features
// into tile 0's primal rows, relu(features) into tile 1's with the light
// head, and PE(dirs) after the features (zero up to the radiance input's
// depth, `k_rad`; with kIdr the raw xyz after PE(dirs) and the gradient's
// columns left as written; the light input's past the features,
// `k_light`, zero too). The sdf tile goes first so that its accumulators
// are dead before the features' are live.
template <int NW, bool kLight, bool kIdr>
__device__ __forceinline__ void sdf_output(
    float* a0, float* a1, unsigned char* t0, unsigned char* t1, const int* Lf,
    const int* Ls, const float* __restrict__ b_sdf, const Enc& enc, int F,
    int k_rad, int k_light, int col0, bool active, int cw, int row0, int n,
    float* __restrict__ sdf_out, float* __restrict__ grad_out, Ring& ring) {
  const Frag f;
  const int r = f.row(), p = 8 * f.w + f.g;
  // the sdf column first: the primal row's and the three tangent rows'
  products<8, 2>(a0, a1, smem_addr(t0), smem_addr(t1), 0, Ls[kK], ring);
  if (cw == 0 && f.tig == 0 && row0 + p < n) {
    sdf_out[row0 + p] = a0[0] + b_sdf[Ls[kBOff]];
    float* g = grad_out + (size_t)(row0 + p) * 3;
    g[0] = a0[2];
    g[1] = a1[0];
    g[2] = a1[2];
  }
  if (kIdr && cw == 0 && f.tig == 0) {
    const int c = F + enc.dd + 3;
    put1(t0, r, c, a0[2]);
    put1(t0, r, c + 1, a1[0]);
    put1(t0, r, c + 2, a1[2]);
  }
  products<NW, 1>(a0, nullptr, smem_addr(t0), 0, col0, Lf[kK], ring);
  bar_sync(1, kConsumers);
  if (active) {
    const float* b = b_sdf + Lf[kBOff];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * f.tig;
      if (col < F) {
        const float2 bb = *reinterpret_cast<const float2*>(b + col);
        const float z0 = a0[4 * j] + bb.x, z1 = a0[4 * j + 1] + bb.y;
        put_pair(t0, r, col, z0, z1);
        if (kLight) put_pair(t1, r, col, fmaxf(z0, 0.f), fmaxf(z1, 0.f));
      }
    }
  }
  // eight threads a point: PE(dirs) (kIdr: then xyz, the gradient's
  // three columns skipped), and the light input's zero padding
  const int pp = threadIdx.x >> 3;
  const float* pd = enc.pd + pp * kPeStride;
  const float* px = enc.px + pp * kPeStride;
  for (int q = threadIdx.x & 7; q < k_rad - F; q += 8) {
    float v = 0.f;
    if (q < enc.dd) {
      v = pd[q];
    } else if (kIdr && q < enc.dd + 3) {
      v = px[q - enc.dd];
    } else if (kIdr && q < enc.dd + 6) {
      continue;
    }
    put1(t0, stream_row(0, pp), F + q, v);
  }
  if (kLight)
    for (int q = F + (threadIdx.x & 7); q < k_light; q += 8)
      put1(t1, stream_row(0, pp), q, 0.f);
  fence_async();
  bar_sync(1, kConsumers);
}

enum NetAct { kRelu = 0, kSoftplus = 1 };

// A layer of the radiance or the light net on one tile's primal rows,
// this warpgroup's NW columns from col0: a hidden layer's activation
// (`kAct`) in place; the last layer's sigmoid, columns below `out_cols`,
// to device memory.
template <int NW, int kAct>
__device__ __forceinline__ void net_layer(float* acc, unsigned char* tile,
                                          const int* L,
                                          const float* __restrict__ b,
                                          int col0, bool active, bool last,
                                          float* __restrict__ out,
                                          int out_cols, int row0, int n,
                                          Ring& ring) {
  products<NW, 1>(acc, nullptr, smem_addr(tile), 0, col0, L[kK], ring);
  if (!last) bar_sync(1, kConsumers);
  if (active) {
    const Frag f;
    const int r = f.row(), p = 8 * f.w + f.g;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
      const float z0 = acc[4 * j] + bb.x, z1 = acc[4 * j + 1] + bb.y;
      if (last) {
        if (row0 + p < n) {
          float* o = out + (size_t)(row0 + p) * out_cols;
          if (col < out_cols) o[col] = __fdividef(1.f, 1.f + __expf(-z0));
          if (col + 1 < out_cols)
            o[col + 1] = __fdividef(1.f, 1.f + __expf(-z1));
        }
      } else if (kAct == kRelu) {
        put_pair(tile, r, col, fmaxf(z0, 0.f), fmaxf(z1, 0.f));
      } else {
        put_pair(tile, r, col, softplus_fast(z0), softplus_fast(z1));
      }
    }
  }
  if (!last) {
    fence_async();
    bar_sync(1, kConsumers);
  }
}

template <bool kLight, bool kIdr>
__global__ void __launch_bounds__(kBlockThreads, 1)
render_core_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                   int n, const unsigned char* __restrict__ w_sdf,
                   const float* __restrict__ b_sdf, Plan fwd,
                   const unsigned char* __restrict__ w_rad,
                   const float* __restrict__ b_rad, Plan rad,
                   const unsigned char* __restrict__ w_l,
                   const float* __restrict__ b_l, Plan lp, int mx, int md,
                   int F, float* __restrict__ sdf_out,
                   float* __restrict__ grad_out, float* __restrict__ rgb_out,
                   float* __restrict__ lmask_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* t0 = align1024(smem_raw);
  unsigned char* t1 = t0 + kTile0Bytes;
  Ring ring = make_ring(t1 + kTile1Bytes);
  float* xs = reinterpret_cast<float*>(t1 + kTile1Bytes + kRingBytes);
  float* ds = xs + kPoints * 3;
  float* px = ds + kPoints * 3;
  float* tx = px + kPoints * kPeStride;
  float* pd = tx + 3 * kPoints * kPeStride;
  __syncthreads();
  const int row0 = blockIdx.x * kPoints;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce(ring, w_sdf, fwd);
      produce(ring, w_rad, rad);
      if (kLight) produce(ring, w_l, lp);
    }
  } else {
    const int cw = threadIdx.x >> 7;
    for (int i = threadIdx.x; i < kPoints * 6; i += kConsumers) {
      const int q = i % (kPoints * 3), r = row0 + q / 3;
      const float* src = i < kPoints * 3 ? x : dirs;
      (i < kPoints * 3 ? xs : ds)[q] =
          r < n ? src[(size_t)r * 3 + q % 3] : 0.f;
    }
    bar_sync(1, kConsumers);
    pe_cache(px, tx, kPoints, xs, mx, threadIdx.x, kConsumers);
    pe_cache(pd, nullptr, kPoints, ds, md, threadIdx.x, kConsumers);
    bar_sync(1, kConsumers);
    const Enc enc{px, tx, pd, 3 + 6 * mx, 3 + 6 * md};
    pe_streams(t0, t1, enc, 0, fwd.L[0][kK], 1.f);
    fence_async();
    bar_sync(1, kConsumers);

    float a0[64], a1[64];
    const int nh = fwd.n - 2;  // then the sdf and the feature products
    for (int l = 0; l < nh; ++l) {
      const int* L = fwd.L[l];
      const Split sp(L[kN], cw);
  #define CALL(W)                                                           \
  tangent_hidden<W>(a0, a1, t0, t1, L, fwd.L[l + 1], b_sdf + L[kBOff],  \
                    enc, sp.col0, sp.active, ring)
      I2SDF_BY_WIDTH(sp.nw, CALL)
  #undef CALL
    }
    {
      const Split sp(fwd.L[nh + 1][kN], cw);
      const int k_light = kLight ? lp.L[0][kK] : F;
  #define CALL(W)                                                          \
  sdf_output<W, kLight, kIdr>(a0, a1, t0, t1, fwd.L[nh + 1], fwd.L[nh],  \
                              b_sdf, enc, F, rad.L[0][kK], k_light,     \
                              sp.col0, sp.active, cw, row0, n, sdf_out, \
                              grad_out, ring)
      I2SDF_BY_WIDTH(sp.nw, CALL)
  #undef CALL
    }
    for (int l = 0; l < rad.n; ++l) {
      const int* L = rad.L[l];
      const Split sp(L[kN], cw);
  #define CALL(W)                                                          \
  net_layer<W, kRelu>(a0, t0, L, b_rad + L[kBOff], sp.col0, sp.active, \
                      l == rad.n - 1, rgb_out, L[kReal], row0, n, ring)
      I2SDF_BY_WIDTH(sp.nw, CALL)
  #undef CALL
    }
    if (kLight) {
      for (int l = 0; l < lp.n; ++l) {
        const int* L = lp.L[l];
        const Split sp(L[kN], cw);
  #define CALL(W)                                                           \
  net_layer<W, kSoftplus>(a0, t1, L, b_l + L[kBOff], sp.col0, sp.active, \
                          l == lp.n - 1, lmask_out, 1, row0, n, ring)
        I2SDF_BY_WIDTH(sp.nw, CALL)
  #undef CALL
      }
    }
  }
}

template <bool kLight, bool kIdr>
cudaError_t launch(const float* x, const float* dirs, int n,
                   const unsigned char* w_sdf, const float* b_sdf,
                   const Plan& fwd, const unsigned char* w_rad,
                   const float* b_rad, const Plan& rad,
                   const unsigned char* w_l, const float* b_l, const Plan& lp,
                   int mx, int md, int F, float* sdf_out, float* grad_out,
                   float* rgb_out, float* lmask_out, void* stream) {
  cudaError_t err =
      set_smem((const void*)render_core_kernel<kLight, kIdr>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kPoints - 1) / kPoints;
  render_core_kernel<kLight, kIdr><<<blocks, kBlockThreads, kSmemBytes,
                                     (cudaStream_t)stream>>>(
      x, dirs, n, w_sdf, b_sdf, fwd, w_rad, b_rad, rad, w_l, b_l, lp, mx, md,
      F, sdf_out, grad_out, rgb_out, lmask_out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_render_core_fwd(
    const float* x, const float* dirs, int n, const void* w_sdf,
    const float* b_sdf, const int* fwd_desc, int n_fwd, const void* w_rad,
    const float* b_rad, const int* rad_desc, int n_rad, const void* w_l,
    const float* b_l, const int* l_desc, int n_l, int mx, int md, int F,
    int idr, float* sdf_out, float* grad_out, float* rgb_out,
    float* lmask_out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd < 3 || n_fwd > kMaxLayers || n_rad < 1 || n_rad > kMaxLayers ||
      n_l < 0 || n_l > kMaxLayers || 3 + 6 * mx > wg::kPeStride ||
      3 + 6 * md > wg::kPeStride)
    return (int)cudaErrorInvalidValue;
  const Plan fwd = read_plan(fwd_desc, n_fwd), rad = read_plan(rad_desc, n_rad);
  const Plan lp = read_plan(l_desc, n_l);
  const auto* ws = (const unsigned char*)w_sdf;
  const auto* wr = (const unsigned char*)w_rad;
  // idr: the radiance input's 6 columns after PE(dirs) inside tile 0
  if (idr && (F + 3 + 6 * md + 6 > rad.L[0][kK] || rad.L[0][kK] > 320))
    return (int)cudaErrorInvalidValue;
  if (n_l > 0 && idr)
    return (int)launch<true, true>(
        x, dirs, n, ws, b_sdf, fwd, wr, b_rad, rad, (const unsigned char*)w_l,
        b_l, lp, mx, md, F, sdf_out, grad_out, rgb_out, lmask_out, stream);
  if (n_l > 0)
    return (int)launch<true, false>(
        x, dirs, n, ws, b_sdf, fwd, wr, b_rad, rad, (const unsigned char*)w_l,
        b_l, lp, mx, md, F, sdf_out, grad_out, rgb_out, lmask_out, stream);
  if (idr)
    return (int)launch<false, true>(x, dirs, n, ws, b_sdf, fwd, wr, b_rad,
                                    rad, nullptr, nullptr, lp, mx, md, F,
                                    sdf_out, grad_out, rgb_out, nullptr,
                                    stream);
  return (int)launch<false, false>(x, dirs, n, ws, b_sdf, fwd, wr, b_rad, rad,
                                   nullptr, nullptr, lp, mx, md, F, sdf_out,
                                   grad_out, rgb_out, nullptr, stream);
}
