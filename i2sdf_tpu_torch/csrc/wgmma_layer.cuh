// Hopper layer primitive of K1 and K3 (sm_90a, plain C interface): an MLP
// layer as wgmma products over activations in shared memory, its weights
// streamed into a ring of stages by bulk copies.
//
// Layout. Activations live in 64-row tiles, each cut into chunks of 64
// columns (128 bytes of bf16 a row, 8 KB a chunk), in wgmma's
// 128-byte-swizzle K-major layout: column c of row r of a chunk sits at
// byte r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2 (`act_off`),
// the swizzle the hardware applies to address bits [4, 7) from bits
// [7, 10), so every tile and slot is 1024-byte aligned. A layer's weights
// arrive as stage images, one per 64-deep chunk of K: W^T's N rows x 64
// columns in the same layout, N * 128 contiguous bytes, written so by the
// host (`i2sdf_tpu_torch/ops/kernels/mma_pack.py::pack_stages`). One bulk
// copy (`cp.async.bulk`, no tensor map) brings a stage into a slot.
//
// Roles. A block is two consumer warpgroups and a producer warp
// (kBlockThreads). One producer thread walks the stages of every layer of
// a `Plan` in the order the consumers take them (`produce`), waiting on a
// slot's `empty` barrier and arming its `full` barrier with the stage's
// bytes. A layer whose plan row sets kStageRows comes as stages of that
// many rows of W^T, all chunks of the first rows first, which the
// consumers take in passes. A consumer warpgroup waits on `full`, issues
// wgmma.mma_async m64nNWk16 (bf16 operands, f32 accumulators, both
// operands in shared memory) over the chunk's 16-deep steps for each of
// its A tiles, and releases the slot (one arrival per consumer warp) once
// they retire (`products`). The plan's rows are `LayerField`s as before:
// K padded to 16, N to one of the widths (8, 16, 32, 64, 128, 256; a
// warpgroup's product is at most 128 wide), `kWOff` the layer's first
// stage in bf16 elements.
//
// Registers. With a ninth warp on the SM a thread may have at most 168
// (three warps share a sub-partition's 16 K registers). A producer
// warpgroup with `setmaxnreg` did no better (ptxas still allocated the
// consumers' code within 168), and a producer thread inside the consumer
// warps cost more (ptxas serializes wgmma next to code that one thread
// runs), so the kernels keep their accumulators within 168: 64 a pass in
// K1, 2 x 64 in K3.
//
// Epilogue. A thread's accumulators of an m64nNW product are rows
// 16 w + g (acc[4 j], acc[4 j + 1]) and 16 w + g + 8 (acc[4 j + 2],
// acc[4 j + 3]) of its warp w's slab, g = lane / 4, at columns
// 8 j + 2 (lane % 4) + {0, 1}. Each kernel's epilogue works on them in
// registers and writes bf16 back into an activation tile with generic
// stores; `fence.proxy.async` then makes them visible to the next
// layer's wgmma (the async proxy) before a barrier.
#pragma once

#include "tangent_common.cuh"

namespace i2sdf {
namespace wg {

constexpr int kRing = 3;                 // stages in flight
constexpr int kSlotBytes = 256 * 128;    // a stage of up to 256 rows
constexpr int kChunkBytes = 64 * 128;    // 64 columns of a 64-row tile
constexpr int kConsumers = 256;          // two consumer warpgroups
constexpr int kBlockThreads = 288;       // ... and the producer warp
constexpr int kConsumerWarps = 8;
constexpr int kPeStride = 65;            // a cached encoding row (f32)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dynamic shared memory's first 1024-byte boundary (the launch asks
// for 1024 bytes more than the kernel lays out).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Byte offset of (row, col) in a tile of 64-column chunks.
__device__ __forceinline__ uint32_t act_off(int row, int col) {
  return (uint32_t)((col >> 6) * kChunkBytes + row * 128 +
                    ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1));
}

__device__ __forceinline__ void put1(unsigned char* tile, int row, int col,
                                     float v) {
  *reinterpret_cast<__nv_bfloat16*>(tile + act_off(row, col)) =
      __float2bfloat16_rn(v);
}

// Columns col, col + 1 (col even) of a row.
__device__ __forceinline__ void put_pair(unsigned char* tile, int row,
                                         int col, float a, float b) {
  *reinterpret_cast<uint32_t*>(tile + act_off(row, col)) = pack_bf16x2(a, b);
}

// softplus100(z) from one exponential and one logarithm, without a branch
// (the fast intrinsics: their error is far below bf16's step). Past
// softplus's linear threshold (100 z > 20) 1 + e rounds to 1, so h = z as
// torch's threshold gives.
__device__ __forceinline__ float softplus_fast(float z) {
  const float e = __expf(-fabsf(100.f * z));
  return fmaxf(z, 0.f) + 0.01f * __logf(1.f + e);
}

// softplus100(z) and its derivative sigmoid(100 z) (1 past the threshold,
// where 1 / (1 + e) rounds to 1), sharing the exponential.
__device__ __forceinline__ void softplus_pair(float z, float& h, float& s) {
  const float t = 100.f * z;
  const float e = __expf(-fabsf(t));
  const float r = __fdividef(1.f, 1.f + e);
  h = fmaxf(z, 0.f) + 0.01f * __logf(1.f + e);
  s = t > 0.f ? r : e * r;
}

// sin and cos of a: reduced by 2 pi in two parts (exact to ~1e-7 for
// |a| up to ~1e5), then the fast intrinsic on [-pi, pi] (error ~4e-7),
// with no slow path for large arguments.
__device__ __forceinline__ void sincos_reduced(float a, float* sn, float* cs) {
  const float k = rintf(a * 0.159154943091895336f);
  float r = fmaf(-k, 6.28318548202514648f, a);
  r = fmaf(-k, -1.74845553146951e-07f, r);
  __sincosf(r, sn, cs);
}

// The positional encoding of `rows` points (xs, 3 coordinates a point)
// into a cache of kPeStride floats a row: [x | sin(x_i 2^j) | cos(x_i
// 2^j)], 3 + 6F columns, each (point, axis, frequency) once
// (`sincos_reduced`, the arguments as `pe_value`'s); with `tan` set, also
// d PE / d x_k into tan[k] (rows of kPeStride): e_k, and f cos / -f sin
// in axis k's blocks, zero in the others. Threads `t` of `nt`; the caller
// syncs after.
__device__ __forceinline__ void pe_cache(float* pe, float* tan, int rows,
                                         const float* xs, int F, int t,
                                         int nt) {
  for (int i = t; i < rows * 3; i += nt) {
    const int r = i / 3, d = i - 3 * r;
    pe[r * kPeStride + d] = xs[i];
    if (tan)
      for (int k = 0; k < 3; ++k)
        tan[(k * rows + r) * kPeStride + d] = k == d ? 1.f : 0.f;
  }
  for (int i = t; i < rows * 3 * F; i += nt) {
    const int r = i / (3 * F), q = i - 3 * F * r, d = q / F, j = q - F * d;
    const float f = ldexpf(1.f, j);
    float sn, cs;
    sincos_reduced(xs[3 * r + d] * f, &sn, &cs);
    pe[r * kPeStride + 3 + q] = sn;
    pe[r * kPeStride + 3 + 3 * F + q] = cs;
    if (tan)
      for (int k = 0; k < 3; ++k) {
        float* tk = tan + (k * rows + r) * kPeStride;
        tk[3 + q] = k == d ? f * cs : 0.f;
        tk[3 + 3 * F + q] = k == d ? -f * sn : 0.f;
      }
  }
}

// ---- barriers, copies, fences ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the barrier has completed the phase of parity `parity`. A
// pipeline that never completes it traps (the launch then reports an
// error) instead of hanging the card: a legitimate wait lasts
// microseconds, the bound tens of seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from device memory to shared memory,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Generic-proxy stores to shared memory become visible to wgmma and bulk
// copies (the async proxy).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading byte offset (unused by this layout),
// stride byte offset 1024 (the next 8 rows), layout type 1 (B128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving accumulator accesses across this point
// (the registers are written asynchronously between issue and wait).
template <int kRegs>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64, NW] (+)= A[64, 16] @ B[16, NW], both operands in shared memory
// (descriptors da, db); d is this thread's NW / 2 accumulators, zeroed
// first when `acc` is 0.
template <int NW>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      int acc);

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// ---- the ring -------------------------------------------------------------

struct Ring {
  unsigned char* slot;  // kRing slots of kSlotBytes
  uint64_t* full;       // kRing barriers: the stage has landed
  uint64_t* empty;      // kRing barriers: every consumer warp is done
  int it;               // stages taken so far (each thread its own count)
};

// Carve the ring from shared memory at `at` (1024-byte aligned); thread 0
// initialises the barriers. The caller syncs the block before use.
__device__ __forceinline__ Ring make_ring(unsigned char* at) {
  Ring r;
  r.slot = at;
  r.full = reinterpret_cast<uint64_t*>(at + kRing * kSlotBytes);
  r.empty = r.full + kRing;
  r.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async();
  }
  return r;
}

constexpr int kRingBytes = kRing * kSlotBytes + 2 * kRing * 8;

// The producer: every stage of every layer of `p`, in order, into the
// ring; a layer with kStageRows set as stages of that many rows of W^T,
// the first rows' chunks first (`mma_pack.pack_stages`).
__device__ __forceinline__ void produce(Ring& r,
                                        const unsigned char* __restrict__ blob,
                                        const Plan& p) {
  for (int l = 0; l < p.n; ++l) {
    const int* L = p.L[l];
    const int n = L[kStageRows] ? L[kStageRows] : L[kN];
    const uint32_t bytes = (uint32_t)n * 128;
    const unsigned char* src = blob + (size_t)L[kWOff] * 2;
    for (int h = 0; h < L[kN]; h += n)
      for (int c = 0; c < L[kK]; c += 64, ++r.it, src += bytes) {
        const int s = r.it % kRing;
        mbar_wait(&r.empty[s], ((r.it / kRing) & 1) ^ 1);
        mbar_expect_tx(&r.full[s], bytes);
        bulk_copy(r.slot + s * kSlotBytes, src, bytes, &r.full[s]);
      }
  }
}

// One layer's products for this warpgroup: for each of its NT A tiles
// (64 rows at shared address a0, a1; accumulators d0, d1: NW / 2 floats
// each), d_t = A_t[:, :K] @ W^T[b_row0 : b_row0 + NW, :K]^T, over the
// layer's stages as they land.
// Every consumer warpgroup runs it on every layer (one that has no
// columns of its own recomputes another's and writes nothing): wgmma
// under a branch that depends on the thread makes ptxas serialize it.
// Returns with the products retired.
template <int NW, int NT>
__device__ __forceinline__ void products(float* d0, float* d1, uint32_t a0,
                                         uint32_t a1, int b_row0, int K,
                                         Ring& r) {
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = -1;
  fence_regs<NW / 2>(d0);
  if constexpr (NT == 2) fence_regs<NW / 2>(d1);
  wgmma_fence();
  for (int c = 0; c * 64 < K; ++c, ++r.it) {
    const int s = r.it % kRing;
    mbar_wait(&r.full[s], (r.it / kRing) & 1);
    const uint64_t db =
        desc_sw128(smem_addr(r.slot + s * kSlotBytes) + b_row0 * 128);
    const uint64_t da0 = desc_sw128(a0 + c * kChunkBytes);
    const uint64_t da1 = desc_sw128(a1 + c * kChunkBytes);
    const int steps = min(4, (K - 64 * c) >> 4);
    for (int ks = 0; ks < steps; ++ks) {
      // +32 bytes a 16-deep step: 2 in the descriptors' address field
      wgmma<NW>(d0, da0 + 2 * ks, db + 2 * ks, (c | ks) != 0);
      if constexpr (NT == 2)
        wgmma<NW>(d1, da1 + 2 * ks, db + 2 * ks, (c | ks) != 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(&r.empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs<NW / 2>(d0);
  if constexpr (NT == 2) fence_regs<NW / 2>(d1);
  if (leader) mbar_arrive(&r.empty[prev]);
}

// Where a thread's accumulators sit: its warp's slab within the
// warpgroup, its row g in the slab, its column pair.
struct Frag {
  int w, g, tig;
  __device__ __forceinline__ Frag()
      : w((threadIdx.x >> 5) & 3),
        g((threadIdx.x & 31) >> 2),
        tig(threadIdx.x & 3) {}
  __device__ __forceinline__ int row() const { return 16 * w + g; }
};

}  // namespace wg
}  // namespace i2sdf
