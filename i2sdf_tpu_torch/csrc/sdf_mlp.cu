// K1 sdf_mlp_nograd: no-grad SDF of the implicit MLP at a batch of points.
//
// Replaces the TPU kernel `i2sdf_tpu/ops/pallas/fused_mlp.py:157
// fused_sdf_mlp` (pallas_call at :225), the error-bound sampler's SDF
// evaluator (`i2sdf_tpu/models/renderer.py:263-271`).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs 2 * (39*256 + 6*256*256 + 256*217 + 256) ~= 0.92 M bf16 flops at
// the net's real widths and moves 16 bytes (xyz in, sdf out), far above
// the card's ~295 flops per byte balance point. Every block also reads
// all of the net's weights from L2 (~0.93 MB of stage images at the
// flagship widths), ~7.3 KB a point at 128 points a block.
//
// Design (`wgmma_layer.cuh`): a block of 128 points, two consumer
// warpgroups of 64 rows each; thread 0 streams each layer's stage images
// (W^T, 64 deep) through a ring of three 32 KB slots by bulk copies. Each warpgroup runs one m64nNk16 wgmma chain over its
// own 64 rows, in passes of up to 128 columns (64 f32 accumulators a
// thread; a 256-wide layer's stages come as two halves), and once a
// layer's passes have retired writes its activations in place over its
// input (bias, Softplus(100), the 1/sqrt(2) before a skip), so one 32 KB
// tile a warpgroup serves every layer. The positional encoding is computed once in the kernel from the
// raw points into an f32 cache and written from it into the tile at
// layer 0 and, scaled by 1/sqrt(2), at the skip's columns. The output
// layer is cut to the sdf column (an N = 8 product).
#include "wgmma_layer.cuh"

namespace i2sdf {
namespace {

using namespace wg;

constexpr int kRows = 128;                    // points a block
constexpr int kPassRows = 128;  // a pass's columns: the host's kStageRows
constexpr int kTileBytes = 4 * kChunkBytes;   // 64 rows x 256 columns
constexpr size_t kSmemBytes = 1024 + 2 * kTileBytes + kRingBytes +
                              kRows * (3 + kPeStride) * sizeof(float);

// scale * the cached encoding (`pe_cache`) into columns [col0, kend) of a
// warpgroup's 64 rows, zero past its d0 columns: two threads a row.
__device__ __forceinline__ void pe_rows(unsigned char* tile, const float* pe,
                                        int d0, int col0, int kend,
                                        float scale) {
  const int t = threadIdx.x & 127, r = t >> 1;
  for (int p = t & 1; p < kend - col0; p += 2)
    put1(tile, r, col0 + p, p < d0 ? pe[r * kPeStride + p] * scale : 0.f);
}

// A hidden layer of NW columns for this warpgroup, in passes of at most
// kPassRows columns (the layer's stages come a pass at a time): each
// pass's products over the tile, its bf16(scale * softplus100(z)) kept
// packed in registers until the last pass has retired, then all written
// in place; the skip's encoding, after a barrier, over the columns where
// the next layer takes it. A pass holds 64 accumulators a thread, so the
// consumers stay within the 168 registers a thread of a 288-thread block
// may have.
template <int NW>
__device__ __forceinline__ void hidden(float* acc, unsigned char* tile,
                                       const int* L, const int* next,
                                       const float* __restrict__ b,
                                       const float* pe, int d0, int bar,
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
      for (int e = 0; e < 4; ++e)
        h[e] = softplus_fast(acc[4 * j + e] + (e & 1 ? bb.y : bb.x)) * scale;
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
  if (next[kFlags] & kSkipIn) {
    bar_sync(bar, 128);
    pe_rows(tile, pe, d0, next[kCol], next[kK], kInvSqrt2);
  }
  fence_async();
  bar_sync(bar, 128);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
sdf_mlp_kernel(const float* __restrict__ pts, float* __restrict__ sdf, int n,
               const unsigned char* __restrict__ wblob,
               const float* __restrict__ bblob, Plan plan, int multires) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  Ring ring = make_ring(base + 2 * kTileBytes);
  float* xs_all = reinterpret_cast<float*>(base + 2 * kTileBytes + kRingBytes);
  float* pe_all = xs_all + kRows * 3;
  __syncthreads();

  const int wgi = threadIdx.x >> 7;
  if (wgi == 2) {
    if (threadIdx.x == kConsumers) produce(ring, wblob, plan);
  } else {
    const int bar = 1 + wgi;  // this warpgroup's named barrier
    const int t = threadIdx.x & 127;
    unsigned char* tile = base + wgi * kTileBytes;
    float* xs = xs_all + wgi * 64 * 3;
    float* pe = pe_all + wgi * 64 * kPeStride;
    const int row0 = blockIdx.x * kRows + wgi * 64;
    const int d0 = 3 + 6 * multires;
    for (int i = t; i < 64 * 3; i += 128) {
      const int r = row0 + i / 3;
      xs[i] = r < n ? pts[(size_t)r * 3 + i % 3] : 0.f;
    }
    bar_sync(bar, 128);
    pe_cache(pe, nullptr, 64, xs, multires, t, 128);
    bar_sync(bar, 128);
    pe_rows(tile, pe, d0, 0, plan.L[0][kK], 1.f);
    fence_async();
    bar_sync(bar, 128);

    float acc[kPassRows / 2];
    const int nh = plan.n - 1;
    for (int l = 0; l < nh; ++l) {
      const int* L = plan.L[l];
      const float* b = bblob + L[kBOff];
      const int* next = plan.L[l + 1];
      switch (L[kN]) {
        case 8: hidden<8>(acc, tile, L, next, b, pe, d0, bar, ring); break;
        case 16: hidden<16>(acc, tile, L, next, b, pe, d0, bar, ring); break;
        case 32: hidden<32>(acc, tile, L, next, b, pe, d0, bar, ring); break;
        case 64: hidden<64>(acc, tile, L, next, b, pe, d0, bar, ring); break;
        case 128: hidden<128>(acc, tile, L, next, b, pe, d0, bar, ring); break;
        default: hidden<256>(acc, tile, L, next, b, pe, d0, bar, ring); break;
      }
    }
    // the output layer, cut to the sdf column: an N = 8 product
    const int* L = plan.L[nh];
    products<8, 1>(acc, nullptr, smem_addr(tile), 0, 0, L[kK], ring);
    const Frag f;
    if (f.tig == 0) {
      const float b0 = bblob[L[kBOff]];
      if (row0 + f.row() < n) sdf[row0 + f.row()] = acc[0] + b0;
      if (row0 + f.row() + 8 < n) sdf[row0 + f.row() + 8] = acc[2] + b0;
    }
  }
}

}  // namespace
}  // namespace i2sdf

extern "C" int i2sdf_sdf_mlp_nograd(const float* pts, float* sdf, int n,
                                    const void* wblob, const float* bblob,
                                    const int* plan_desc, int n_layers,
                                    int multires, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_layers < 2 || n_layers > kMaxLayers || 3 + 6 * multires > kPeStride)
    return (int)cudaErrorInvalidValue;
  const Plan plan = read_plan(plan_desc, n_layers);
  cudaError_t err = set_smem((const void*)sdf_mlp_kernel, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  sdf_mlp_kernel<<<blocks, wg::kBlockThreads, kSmemBytes,
                   (cudaStream_t)stream>>>(
      pts, sdf, n, (const unsigned char*)wblob, bblob, plan, multires);
  return (int)cudaGetLastError();
}

extern "C" const char* i2sdf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
