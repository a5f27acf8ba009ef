// K8 bg_core_fwd: the NeRF++ background's pair of MLPs at a batch of points
// on the inverted sphere, (x4 (N, 4), dirs (N, 3)) -> (sigma (N, 1),
// rgb (N, 3)).
//
// Replaces the forward of the TPU kernel `i2sdf_tpu/ops/pallas/fused_bg.py:
// 209 get_bg_core_op` (pallas_call at :289, `_make_fwd_kernel` at
// :95-118), the background branch of the renderer
// (`i2sdf_tpu/models/renderer.py:405-444`).
//
// What bounds it on the H100: operations. At the background config
// (implicit 8 x 256 on PE(x4) with multires 10, a skip at layer 4,
// radiance 1 x 128 on [PE(view) 27 ; features 256]) a point costs ~0.5 M
// multiply-adds in bf16 and moves 40 bytes (x4 and dirs in, sigma and rgb
// out): ~25 k flops per byte, far above the card's ~295.
//
// Design: K1's (`sdf_mlp.cu`, `wgmma_layer.cuh`) for both nets in one
// launch. A block of 128 points, two consumer warpgroups of 64 rows each,
// each with its own 64-row tile of five 64-column chunks (the radiance
// input is 288 deep); one producer thread bulk-copies every layer's stage
// images (`bg_core.BgStages`: stages of at most 128 rows of W^T, a
// 256-wide layer in two passes) into a ring of three 32 KB slots. Each
// warpgroup runs a layer's passes of up to 128 columns (64 f32
// accumulators a thread), keeps the earlier passes' bf16 results packed in
// registers and writes the layer in place over its input once the last
// pass has retired. The encodings are computed from the raw coordinates
// straight into the tile: PE(x4) (84 columns) at layer 0 and, scaled by
// 1/sqrt(2), at the skip's columns, PE(view) after the features. The
// implicit output layer is two products, as K3's: sigma alone (an N = 8
// product, its column 0) to device memory, then the features (N = 256)
// into the tile. The radiance net's last layer is an N = 8 product whose
// sigmoid goes to device memory.
#include "bg_common.cuh"

namespace i2sdf {
namespace {

using namespace wg;

constexpr int kRows = 128;                   // points a block
constexpr int kPassRows = 128;  // a pass's columns: the host's kStageRows
constexpr int kTileBytes = 5 * kChunkBytes;  // 64 rows x 320 columns
// the points (4 floats a row) and the directions (3)
constexpr size_t kSmemBytes =
    1024 + 2 * kTileBytes + kRingBytes + kRows * 7 * sizeof(float);

enum Act { kSoftplus = 0, kIdentity = 1, kRelu = 2 };

// A layer of NW columns for this warpgroup's 64 rows, in passes of at most
// kPassRows columns (the layer's stages come a pass at a time): each
// pass's products over the tile, its bf16(act(z)) (softplus100 times the
// 1/sqrt(2) before a skip; the identity; relu) kept packed in registers
// until the last pass has retired, then all written in place. The caller
// fences and syncs.
template <int NW, int kAct>
__device__ __forceinline__ void layer(float* acc, unsigned char* tile,
                                      const int* L,
                                      const float* __restrict__ b,
                                      Ring& ring) {
  constexpr int PW = NW < kPassRows ? NW : kPassRows, P = NW / PW;
  uint32_t held[(P - 1) * PW / 4 + 1];  // the earlier passes, packed
  const Frag f;
  const float scale = (L[kFlags] & kScale) ? kInvSqrt2 : 1.f;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    products<PW, 1>(acc, nullptr, smem_addr(tile), 0, 0, L[kK], ring);
#pragma unroll
    for (int j = 0; j < PW / 8; ++j) {
      const int col = q * PW + 8 * j + 2 * f.tig;
      const float2 bb = *reinterpret_cast<const float2*>(b + col);
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = acc[4 * j + e] + (e & 1 ? bb.y : bb.x);
        h[e] = kAct == kSoftplus ? softplus_fast(z) * scale
               : kAct == kRelu   ? fmaxf(z, 0.f)
                                 : z;
      }
      if (q < P - 1) {
        held[(q * PW / 8 + j) * 2] = pack_bf16x2(h[0], h[1]);
        held[(q * PW / 8 + j) * 2 + 1] = pack_bf16x2(h[2], h[3]);
      } else {
        put_pair(tile, f.row(), col, h[0], h[1]);
        put_pair(tile, f.row() + 8, col, h[2], h[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < (P - 1) * PW / 8; ++i) {
    const int col = 8 * i + 2 * f.tig;
    *reinterpret_cast<uint32_t*>(tile + act_off(f.row(), col)) = held[2 * i];
    *reinterpret_cast<uint32_t*>(tile + act_off(f.row() + 8, col)) =
        held[2 * i + 1];
  }
}

#define I2SDF_LAYER(ACT)                                               \
  switch (L[kN]) {                                                     \
    case 8: layer<8, ACT>(acc, tile, L, b + L[kBOff], ring); break;    \
    case 16: layer<16, ACT>(acc, tile, L, b + L[kBOff], ring); break;  \
    case 32: layer<32, ACT>(acc, tile, L, b + L[kBOff], ring); break;  \
    case 64: layer<64, ACT>(acc, tile, L, b + L[kBOff], ring); break;  \
    case 128: layer<128, ACT>(acc, tile, L, b + L[kBOff], ring); break; \
    default: layer<256, ACT>(acc, tile, L, b + L[kBOff], ring); break; \
  }

__global__ void __launch_bounds__(kBlockThreads, 1)
bg_fwd_kernel(const float* __restrict__ x4, const float* __restrict__ dirs,
              int n, const unsigned char* __restrict__ w_imp,
              const float* __restrict__ b_imp, Plan imp,
              const unsigned char* __restrict__ w_rad,
              const float* __restrict__ b_rad, Plan rad, int d_in, int fx,
              int fv, int F, float* __restrict__ sigma,
              float* __restrict__ rgb) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  Ring ring = make_ring(base + 2 * kTileBytes);
  float* pts_all = reinterpret_cast<float*>(base + 2 * kTileBytes + kRingBytes);
  float* ds_all = pts_all + kRows * 4;
  __syncthreads();

  const int wgi = threadIdx.x >> 7;
  if (wgi == 2) {
    if (threadIdx.x == kConsumers) {
      produce(ring, w_imp, imp);
      produce(ring, w_rad, rad);
    }
    return;
  }
  const int bar = 1 + wgi;  // this warpgroup's named barrier
  const int t = threadIdx.x & 127;
  unsigned char* tile = base + wgi * kTileBytes;
  float* xs = pts_all + wgi * 64 * 4;
  float* ds = ds_all + wgi * 64 * 3;
  const int row0 = blockIdx.x * kRows + wgi * 64;
  load_rows_f32(xs, x4, d_in, 64, row0, n, t, 128);
  load_rows_f32(ds, dirs, 3, 64, row0, n, t, 128);
  bar_sync(bar, 128);
  fill_pe(tile, xs, d_in, fx, 0, imp.L[0][kK], 1.f, t, 128);
  fence_async();
  bar_sync(bar, 128);

  float acc[kPassRows / 2];
  const Frag f;
  const int nh = imp.n - 2;  // then the sigma and the feature products
  for (int l = 0; l < nh; ++l) {
    const int* L = imp.L[l];
    const float* b = b_imp;
    I2SDF_LAYER(kSoftplus)
    const int* next = imp.L[l + 1];
    if (next[kFlags] & kSkipIn) {
      bar_sync(bar, 128);
      fill_pe(tile, xs, d_in, fx, next[kCol], next[kK], kInvSqrt2, t, 128);
    }
    fence_async();
    bar_sync(bar, 128);
  }
  // the output layer: sigma (column 0 of an N = 8 product) to device
  // memory, then the features into the tile and PE(view) after them
  {
    const int* Ls = imp.L[nh];
    products<8, 1>(acc, nullptr, smem_addr(tile), 0, 0, Ls[kK], ring);
    if (f.tig == 0) {
      const float b0 = b_imp[Ls[kBOff]];
      if (row0 + f.row() < n) sigma[row0 + f.row()] = acc[0] + b0;
      if (row0 + f.row() + 8 < n) sigma[row0 + f.row() + 8] = acc[2] + b0;
    }
    const int* L = imp.L[nh + 1];
    const float* b = b_imp;
    I2SDF_LAYER(kIdentity)
    bar_sync(bar, 128);
    fill_pe(tile, ds, 3, fv, F, rad.L[0][kK], 1.f, t, 128);
    fence_async();
    bar_sync(bar, 128);
  }
  for (int l = 0; l < rad.n - 1; ++l) {
    const int* L = rad.L[l];
    const float* b = b_rad;
    I2SDF_LAYER(kRelu)
    fence_async();
    bar_sync(bar, 128);
  }
  // the radiance output: the sigmoid of an N = 8 product's real columns
  const int* L = rad.L[rad.n - 1];
  products<8, 1>(acc, nullptr, smem_addr(tile), 0, 0, L[kK], ring);
  const int col = 2 * f.tig, d_out = L[kReal];
  const float* b = b_rad + L[kBOff];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + f.row() + 8 * h;
    if (r >= n) continue;
    if (col < d_out)
      rgb[(size_t)r * d_out + col] =
          __fdividef(1.f, 1.f + __expf(-(acc[2 * h] + b[col])));
    if (col + 1 < d_out)
      rgb[(size_t)r * d_out + col + 1] =
          __fdividef(1.f, 1.f + __expf(-(acc[2 * h + 1] + b[col + 1])));
  }
}

#undef I2SDF_LAYER

}  // namespace
}  // namespace i2sdf

// The plans are `bg_core.BgStages`' `imp` (the hidden layers, then the
// sigma and the feature products) and `rad`.
extern "C" int i2sdf_bg_core_fwd(const float* x4, const float* dirs, int n,
                                 const void* w_imp, const float* b_imp,
                                 const int* plan_imp, int n_imp,
                                 const void* w_rad, const float* b_rad,
                                 const int* plan_rad, int n_rad, int d_in,
                                 int fx, int fv, int F, float* sigma,
                                 float* rgb, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_imp < 3 || n_imp > kMaxLayers || n_rad < 1 || n_rad > kMaxLayers ||
      d_in < 1 || d_in > 4)
    return (int)cudaErrorInvalidValue;
  const Plan imp = read_plan(plan_imp, n_imp), rad = read_plan(plan_rad, n_rad);
  cudaError_t err = set_smem((const void*)bg_fwd_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  bg_fwd_kernel<<<blocks, wg::kBlockThreads, kSmemBytes,
                  (cudaStream_t)stream>>>(
      x4, dirs, n, (const unsigned char*)w_imp, b_imp, imp,
      (const unsigned char*)w_rad, b_rad, rad, d_in, fx, fv, F, sigma, rgb);
  return (int)cudaGetLastError();
}
