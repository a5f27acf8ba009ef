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
// Design: two launches and the fixed-order sums, on `wgmma_layer.cuh`.
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
// 2. `k4_wgrad_kernel`: every dW = A^T B over the points (SDF layers:
//    X^T dz + da^T r; radiance and light layers X^T dz) on wgmma with
//    both operands MN-major (the transpose bits), read straight from the
//    operand regions the sweep wrote: a block takes 128 rows of dW (two
//    A chunks, one a warpgroup) by 256 columns (four B chunks) over one
//    range of points, the producer bulk-copying each 64-point block's
//    chunks into a four-slot ring; the partial sums go to device memory.
// 3. `sum_kernel` (common.cuh): the ranges' partial sums and the blocks'
//    bias rows added in a fixed order, so the result does not change from
//    run to run.
//
// The activation derivative is stashed as q (`stash_q`), so 100 s (1 - s)
// keeps bf16's relative precision. The forward recompute's activations,
// rgb, the light mask and the encoding take the accurate expf, log1pf,
// sinf and cosf (common.cuh), as the plain op and the reference do, so
// the kernel rounds where its replay (tests/test_torch_bwd_replay.py)
// and K6 round. The encoding's Jacobian is the closed
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
#include "wgmma_layer.cuh"

namespace i2sdf {
namespace {

using namespace wg;

constexpr int kPts = 64;                     // points a block
constexpr int kSlots = 5;                    // the sweep's ring
constexpr int kTChunks = 5;                  // T: 64 rows x 320 columns
constexpr int kTBytes = kTChunks * kChunkBytes;
constexpr int kWsumCols = 320;
using KRing = RingN<kSlots>;
constexpr size_t kSmemBytes =
    1024 + kTBytes + ring_bytes<kSlots>() + 16 +
    (size_t)(kPts * (3 + 3 + kCot + 8) + 4 * kWsumCols) * sizeof(float);

// ring table items (`render_core.K4Plan.script`): four int64 each,
// [kind | base << 8, byte offset, bytes a block (added per block), bytes]
enum ItemKind { kItemLoad = 0, kItemStage = 1, kItemWait = 2 };
constexpr int kBases = 5;   // scratch, sdf, radiance, light, transposed
struct Bases {
  const unsigned char* p[kBases];
};

// The scratch regions (`render_core.K4Plan.regions`): byte offset of
// block 0's tile and bytes a block, for each kind and layer.
enum RegionKind {
  kRegX = 0, kRegDz, kRegDa, kRegR,        // SDF layers' operands
  kRegQ, kRegAh, kRegDzx,                  // the SDF stash
  kRegRx, kRegRdz,                         // radiance layers' operands
  kRegLx, kRegLdz, kRegLs, kRegClg,        // the light net's
  kRegKinds
};
constexpr int kRegLayers = 16;
constexpr int kRegDb = kRegKinds * kRegLayers * 2;   // then the bias rows

// ---- the transposed products (`k4_wgrad_kernel`) ----------------------------

// Descriptor of an MN-major operand in the 128-byte swizzle: 64-element
// atoms along M or N 8 KB apart (a chunk of an operand region), 8-row
// groups along K 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64, 256] (+)= A[16, 64]^T B[16, 256], both operands MN-major.
__device__ __forceinline__ void wgmma_mn256(float* d, uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}



// ---- the sweep's consumer side --------------------------------------------

struct Args {
  const float* x;
  const float* dirs;
  const float* cot;
  int n;
  Bases w;                 // [scratch, sdf, rad, light, transposed] blobs
  const float* b_sdf;      // K3's biases: the SDF stage chain's,
  const float* b_rad;      // the radiance chain's,
  const float* b_l;        // the light chain's
  const float* wsdf;       // ah of the output layer: W[:, sdf] (bf16)
  Plan fwd, tsdf, rad, trad, light, tlight;
  int mx, md, F;
  const long long* reg;    // regions, then the bias rows' offsets
  const long long* script;
  int n_items;
  unsigned char* scratch;
};

// The consumers' state: the tile (everything else in shared memory sits
// at fixed offsets from it, `Smem`), the arguments, the ring's count of
// items taken, the tile barrier's phase, the sweeps stored so far, this
// thread's warpgroup. Kept this small so the accumulators have the
// registers.
struct Ctx {
  unsigned char* T;
  const Args* a;
  int it, tphase, done, cw;
};

// Shared memory after the tile: the ring's slots and barriers, the tile
// barrier, the stored-sweeps count, the points, directions, cotangents,
// rgb and the warps' column sums.
struct Smem {
  static __device__ __forceinline__ unsigned char* slots(const Ctx& c) {
    return c.T + kTBytes;
  }
  static __device__ __forceinline__ uint64_t* full(const Ctx& c) {
    return reinterpret_cast<uint64_t*>(c.T + kTBytes + kSlots * kSlotBytes);
  }
  static __device__ __forceinline__ uint64_t* empty(const Ctx& c) {
    return full(c) + kSlots;
  }
  static __device__ __forceinline__ unsigned char* after(const Ctx& c) {
    return c.T + kTBytes + ring_bytes<kSlots>();
  }
  static __device__ __forceinline__ uint64_t* tbar(const Ctx& c) {
    return reinterpret_cast<uint64_t*>(after(c));
  }
  static __device__ __forceinline__ volatile int* stored(const Ctx& c) {
    return reinterpret_cast<volatile int*>(after(c) + 8);
  }
  static __device__ __forceinline__ float* xs(const Ctx& c) {
    return reinterpret_cast<float*>(after(c) + 16);
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
  static __device__ __forceinline__ float* wsum(const Ctx& c) {
    return rgb(c) + kPts * 8;
  }
  static __device__ __forceinline__ float* dbrow(const Ctx& c) {
    return reinterpret_cast<float*>(c.a->scratch + c.a->reg[kRegDb]) +
           (size_t)blockIdx.x * c.a->reg[kRegDb + 1];
  }
};

__device__ __forceinline__ unsigned char* region(const Ctx& c, int kind,
                                                 int l) {
  const long long* r = c.a->reg + 2 * (kind * kRegLayers + l);
  return c.a->scratch + r[0] + (long long)blockIdx.x * r[1];
}

__device__ __forceinline__ int chunks(int cols) { return (cols + 63) >> 6; }

__device__ __forceinline__ unsigned char* slot_at(const Ctx& c, int s) {
  return Smem::slots(c) + s * kSlotBytes;
}

// The next ring item, once it has landed: its slot.
__device__ __forceinline__ int take(Ctx& c) {
  const int s = c.it % kSlots;
  mbar_wait(&Smem::full(c)[s], (c.it / kSlots) & 1);
  ++c.it;
  return s;
}

// A loaded item read by every consumer warp: each warp's leader frees it.
__device__ __forceinline__ void release(Ctx& c, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&Smem::empty(c)[s]);
}

// T (its first `ch` chunks, written and fenced) to an operand region.
__device__ __forceinline__ void store_T(Ctx& c, int kind, int l, int ch) {
  if (threadIdx.x == 0) {
    bulk_store(region(c, kind, l), c.T, (uint32_t)ch * kChunkBytes);
    bulk_commit();
  }
}

// T may be written again: its bulk store has read it.
__device__ __forceinline__ void wait_T(Ctx& c) {
  if (threadIdx.x == 0) bulk_wait_read();
  bar_sync(1, kConsumers);
}

// Staging slots s (and s2 if >= 0), written and fenced, to a stash region;
// freed once the copy has read them.
__device__ __forceinline__ void stage_out(Ctx& c, int s, int s2, int kind,
                                          int l, uint32_t bytes) {
  bar_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    unsigned char* dst = region(c, kind, l);
    bulk_store(dst, slot_at(c, s), bytes);
    if (s2 >= 0) bulk_store(dst + kSlotBytes, slot_at(c, s2), kSlotBytes);
    bulk_commit();
    bulk_wait_read();
    mbar_arrive_n(&Smem::empty(c)[s], kConsumerWarps);
    if (s2 >= 0) mbar_arrive_n(&Smem::empty(c)[s2], kConsumerWarps);
  }
}

// The consumers' stores so far are complete in device memory; the
// producer may bring them back (its table's waits count these).
__device__ __forceinline__ void sweep_done(Ctx& c) {
  ++c.done;
  if (threadIdx.x == 0) {
    bulk_wait_all();
    __threadfence_block();
    *Smem::stored(c) = c.done;
  }
}

// T's first `ch` chunks from a region of the scratch (complete: stored
// before the last sweep_done).
__device__ __forceinline__ void load_T(Ctx& c, const unsigned char* src,
                                       int ch) {
  if (threadIdx.x == 0) {
    bulk_wait_read();
    mbar_expect_tx(Smem::tbar(c), (uint32_t)ch * kChunkBytes);
    bulk_copy(c.T, src, (uint32_t)ch * kChunkBytes, Smem::tbar(c));
  }
  mbar_wait(Smem::tbar(c), c.tphase);
  c.tphase ^= 1;
}

__device__ __forceinline__ float2 get_pair(const unsigned char* tile, int row,
                                           int col) {
  return unpack_bf16x2(
      *reinterpret_cast<const uint32_t*>(tile + act_off(row, col)));
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

// Column sums of a warpgroup's 64 rows: each warp's 16 rows by shuffles,
// into wsum[w][col]; `bias_row` then adds the four warps in order.
__device__ __forceinline__ void col_sums(float* wsum, const Frag& f, int col,
                                         float a0, float a1, float b0,
                                         float b1) {
  float v0 = a0 + b0, v1 = a1 + b1;
#pragma unroll
  for (int m = 4; m < 32; m <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, m);
    v1 += __shfl_xor_sync(0xffffffffu, v1, m);
  }
  if (f.g == 0) {
    wsum[f.w * kWsumCols + col] = v0;
    wsum[f.w * kWsumCols + col + 1] = v1;
  }
}

// The block's bias-gradient row at `off`: cols columns of wsum (after a
// barrier), the four warps added in order.
__device__ __forceinline__ void bias_row(Ctx& c, int off, int cols) {
  bar_sync(1, kConsumers);
  const float* w = Smem::wsum(c);
  for (int k = threadIdx.x; k < cols; k += kConsumers)
    Smem::dbrow(c)[off + k] = ((w[k] + w[kWsumCols + k]) +
                               w[2 * kWsumCols + k]) +
                              w[3 * kWsumCols + k];
}

__device__ __forceinline__ int db_off(const Ctx& c, int p) {
  return (int)c.a->reg[kRegDb + 2 + p];
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

enum Fill { kFillPeX, kFillPeDirs, kFillDge };

// scale * (PE(x), PE(dirs) or dg_emb) into columns [col0, kend) of T,
// zero past the encoding's width: four threads a row.
__device__ __forceinline__ void fill_T(Ctx& c, int what, int col0, int kend,
                                       float scale) {
  const int r = threadIdx.x >> 2;
  const int F = what == kFillPeDirs ? c.a->md : c.a->mx, d0 = 3 + 6 * F;
  const float* x3 = (what == kFillPeDirs ? Smem::ds(c) : Smem::xs(c)) + 3 * r;
  for (int q = threadIdx.x & 3; q < kend - col0; q += 4) {
    float v = 0.f;
    if (q < d0)
      v = what == kFillDge ? dge_at(x3, Smem::cot(c) + r * kCot, F, q)
                           : pe_value(x3, F, q);
    put1(c.T, r, col0 + q, v * scale);
  }
}

// After a layer's products: T's bulk store has read it; both warpgroups'
// products have retired.
__device__ __forceinline__ void after_products(Ctx& c) {
  if (threadIdx.x == 0) bulk_wait_read();
  bar_sync(1, kConsumers);
}

template <int NW>
__device__ __forceinline__ void product(Ctx& c, float* acc, const int* L,
                                        int col0) {
  KRing r{Smem::slots(c), Smem::full(c), Smem::empty(c), c.it};
  products<NW, 1>(acc, nullptr, smem_addr(c.T), 0, col0, L[kK], r);
  c.it = r.it;
  after_products(c);
}

// ---- the sweeps, one layer each -------------------------------------------

// Forward recompute, hidden layer l: h into T (columns below the next
// layer's skip column, then the encoding there), q to its stash.
template <int NW>
__device__ __forceinline__ void fwd_hidden(Ctx& c, float* acc, int l,
                                           const Split& sp) {
  const int* L = c.a->fwd.L[l];
  const int* nx = c.a->fwd.L[l + 1];
  product<NW>(c, acc, L, sp.col0);
  const int s = take(c);
  unsigned char* S = slot_at(c, s);
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
        put_pair(S, f.row() + 8 * h, col, stash_q(z0), stash_q(z1));
      }
    }
  }
  if (nx[kFlags] & kSkipIn) {
    bar_sync(1, kConsumers);
    fill_T(c, kFillPeX, nx[kCol], nx[kK], kInvSqrt2);
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
          put_pair(slot_at(c, s), row, col, dsoftplus100(z0),
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
        col_sums(Smem::wsum(c), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  if constexpr (last && kNet == kNetLight) {
    // the light net's dz: zero past the product's columns, its bias row
    for (int i = threadIdx.x; i < kPts * (64 - L[kN]); i += kConsumers)
      put1(c.T, i / (64 - L[kN]), L[kN] + i % (64 - L[kN]), 0.f);
    bias_row(c, db_off(c, c.a->fwd.n - 1 + c.a->rad.n + l), L[kReal]);
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
  const unsigned char* M = slot_at(c, s);
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
      col_sums(Smem::wsum(c), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  release(c, s);
  const int base =
      kNet == kNetRad ? c.a->fwd.n - 1 : c.a->fwd.n - 1 + c.a->rad.n;
  bias_row(c, db_off(c, base + l - 1), P.L[l - 1][kReal]);
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
          const float2 g = *f32_at(slot_at(c, sa), slot_at(c, sb), row, col);
          v[2 * h] += g.x;
          v[2 * h + 1] += g.y;
        }
        put_pair(c.T, row, col, v[2 * h], v[2 * h + 1]);
      }
      col_sums(Smem::wsum(c), f, col, v[0], v[1], v[2], v[3]);
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
  bias_row(c, db_off(c, ns - 1), F);
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < kPts; ++r) s += Smem::cot(c)[r * kCot + 3];
    Smem::dbrow(c)[db_off(c, ns - 1) + F] = s;
  }
  fence_async();
  bar_sync(1, kConsumers);
}

// Reverse sweep through W_l^T (l = ns-2 .. 1): ah_l = scale (r_l W_l^T)
// on the hidden columns, staged in f32; r_{l-1} = ah_l s_{l-1} into T.
template <int NW>
__device__ __forceinline__ void rev_layer(Ctx& c, float* acc, int l,
                                          const Split& sp) {
  const int ns = c.a->fwd.n - 1;
  const int* Lt = c.a->tsdf.L[ns - 1 - l];
  product<NW>(c, acc, Lt, sp.col0);
  const int sq = take(c), sa = take(c), sb = take(c);
  if (sp.active) {
    const Frag f;
    const float scale = (Lt[kFlags] & kScale) ? kInvSqrt2 : 1.f;
    const int n_h = Lt[kReal];
    const unsigned char* Q = slot_at(c, sq);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float a0 = col < n_h ? acc[4 * j + 2 * h] * scale : 0.f;
        const float a1 = col + 1 < n_h ? acc[4 * j + 2 * h + 1] * scale : 0.f;
        *f32_at(slot_at(c, sa), slot_at(c, sb), row, col) = make_float2(a0, a1);
        // no branch on a value of the accumulators (ptxas would
        // serialize the wgmma): the stash is read whole, masked by select
        const float2 q = get_pair(Q, row, col);
        put_pair(c.T, row, col, col < n_h ? a0 * stash_s(q.x) : 0.f,
                 col + 1 < n_h ? a1 * stash_s(q.y) : 0.f);
      }
    }
  }
  release(c, sq);
  fence_async();
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
    const unsigned char* Q = slot_at(c, sq);
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
          ah = *f32_at(slot_at(c, sa), slot_at(c, sb), row, col);
        const float r0 = acc[4 * j + 2 * h], r1 = acc[4 * j + 2 * h + 1];
        const bool k0 = col < n_h, k1 = col + 1 < n_h;
        put_pair(c.T, row, col, k0 ? r0 * stash_s(q.x) * scale : 0.f,
                 k1 ? r1 * stash_s(q.y) * scale : 0.f);
        put_pair(slot_at(c, ss), row, col,
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
    const unsigned char* Q = slot_at(c, sq);
    const unsigned char* Z = slot_at(c, sz);
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
      col_sums(Smem::wsum(c), f, col, v[0], v[1], v[2], v[3]);
    }
  }
  release(c, sq);
  release(c, sz);
  bias_row(c, db_off(c, l - 1), c.a->fwd.L[l - 1][kReal]);
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
    const unsigned char* X = slot_at(c, sx);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = sp.col0 + 8 * j + 2 * f.tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row() + 8 * h;
        const float2 m = get_pair(X, row, col);
        *f32_at(slot_at(c, sa), slot_at(c, sb), row, col) =
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
    load_T(c, region(c, kRegRx, 0), chunks(F));
  }
}

// The producer: the ring table in order (`render_core.K4Plan.script`).
__device__ __forceinline__ void run_script(KRing& r, const Args& a,
                                           volatile int* stored) {
  for (int i = 0; i < a.n_items; ++i) {
    const long long* it = a.script + 4 * i;
    const int kind = (int)(it[0] & 255), base = (int)(it[0] >> 8);
    if (kind == kItemWait) {
      uint32_t spins = 0;
      while (*stored < it[1])
        if (++spins == (1u << 28)) __trap();
      __threadfence_block();
      asm volatile("fence.proxy.async;\n" ::: "memory");
      continue;
    }
    const int s = r.it % kSlots;
    mbar_wait(&r.empty[s], ((r.it / kSlots) & 1) ^ 1);
    if (kind == kItemLoad) {
      const uint32_t bytes = (uint32_t)it[3];
      mbar_expect_tx(&r.full[s], bytes);
      bulk_copy(r.slot + s * kSlotBytes,
                a.w.p[base] + it[1] + (long long)blockIdx.x * it[2], bytes,
                &r.full[s]);
    } else {
      mbar_arrive(&r.full[s]);   // a staging slot: handed out empty
    }
    ++r.it;
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
  fill_T(c, kFillPeX, 0, a.fwd.L[0][kK], 1.f);
  fence_async();
  bar_sync(1, kConsumers);
  for (int l = 0; l < ns - 1; ++l) {
    store_T(c, kRegX, l, chunks(a.fwd.L[l][kK]));
    const Split sp(a.fwd.L[l][kN], c.cw);
#define CALL(W) fwd_hidden<W>(c, acc, l, sp)
    I2SDF_BY_WIDTH(sp.nw, CALL)
#undef CALL
  }
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
      Smem::dbrow(c)[db_off(c, ns + nr - 1) + k] = s;
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

  // ---- 4. reverse sweep: r_l stored, ah_l staged ------------------------
  wait_T(c);
  for (int i = threadIdx.x; i < kPts * 64 * chunks(out_k); i += kConsumers) {
    const int w = 64 * chunks(out_k), r = i / w, col = i % w;
    put1(c.T, r, col, col == F ? 1.f : 0.f);
  }
  fence_async();
  bar_sync(1, kConsumers);
  store_T(c, kRegR, ns - 1, chunks(out_k));
  {
    // r_{ns-2} = ah_{ns-1} s_{ns-2}, ah_{ns-1} = W_{ns-1}[:, sdf]
    const int sq = take(c);
    wait_T(c);
    const int* L = a.fwd.L[ns - 2];
    const int n_h = L[kReal], N = 64 * chunks(L[kN]);
    const unsigned char* Q = slot_at(c, sq);
    for (int i = threadIdx.x; i < kPts * N; i += kConsumers) {
      const int r = i / N, col = i % N;
      put1(c.T, r, col,
           col < n_h ? a.wsdf[col] * stash_s(get1(Q, r, col)) : 0.f);
    }
    release(c, sq);
    fence_async();
    bar_sync(1, kConsumers);
  }
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
  load_T(c, region(c, kRegDz, ns - 1), chunks(out_k));
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

template <bool kLight, bool kCoupled>
__global__ void __launch_bounds__(kBlockThreads, 1)
k4_sweep_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  Ctx c;
  c.T = align1024(smem_raw);
  c.a = &a;
  c.it = c.tphase = c.done = 0;
  c.cw = threadIdx.x >> 7;
  KRing ring = make_ring<kSlots>(Smem::slots(c));
  if (threadIdx.x == 0) {
    mbar_init(Smem::tbar(c), 1);
    *Smem::stored(c) = 0;
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
    if (threadIdx.x == kConsumers) run_script(ring, a, Smem::stored(c));
    return;
  }
  consume<kLight, kCoupled>(c);
}


// ---- 2. the weight-gradient products ---------------------------------------

constexpr int kWSlots = 4;
constexpr int kWSlotBytes = 6 * kChunkBytes;   // two A chunks, four B chunks
constexpr int kMaxWJobs = 24;
constexpr size_t kWSmemBytes = 1024 + kWSlots * kWSlotBytes + 2 * kWSlots * 8;

// One weight gradient (`render_core.K4Plan.jobs`): dW (K x N) = sum over
// its `pairs` operand pairs and the point blocks of A^T B; the regions'
// byte offsets (block 0) and bytes a block; the grid's tiles of 128 rows
// x 256 columns, each over `per` blocks of one of `splits` ranges; the
// partials (splits, K, N) at f32 element `part`.
struct WJob {
  long long a_off[2], a_stride[2], b_off[2], b_stride[2], part;
  int pairs, K, N, ka, nblk, per, splits, tiles_k, tiles_n, first;
};
struct WJobs {
  WJob j[kMaxWJobs];
  int n;
};

__global__ void __launch_bounds__(kBlockThreads, 1)
k4_wgrad_kernel(const __grid_constant__ WJobs jobs,
                const unsigned char* __restrict__ scratch,
                float* __restrict__ ws32) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + kWSlots * kWSlotBytes);
  uint64_t* empty = full + kWSlots;
  int ji = 0;
  while (ji < jobs.n - 1 && (int)blockIdx.x >= jobs.j[ji + 1].first) ++ji;
  const WJob& J = jobs.j[ji];
  int t = blockIdx.x - J.first;
  const int tn = t % J.tiles_n;
  t /= J.tiles_n;
  const int tk = t % J.tiles_k, split = t / J.tiles_k;
  const int b0 = split * J.per, b1 = min(J.nblk, b0 + J.per);
  const int ka = min(2, J.ka - 2 * tk);
  const int items = J.pairs * (b1 - b0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      for (int i = 0; i < items; ++i) {
        const int p = i / (b1 - b0), b = b0 + i % (b1 - b0), s = i % kWSlots;
        mbar_wait(&empty[s], ((i / kWSlots) & 1) ^ 1);
        const uint32_t abytes = (uint32_t)ka * kChunkBytes;
        mbar_expect_tx(&full[s], abytes + 4 * kChunkBytes);
        unsigned char* dst = slots + s * kWSlotBytes;
        bulk_copy(dst, scratch + J.a_off[p] + (long long)b * J.a_stride[p] +
                           (long long)tk * 2 * kChunkBytes,
                  abytes, &full[s]);
        bulk_copy(dst + 2 * kChunkBytes,
                  scratch + J.b_off[p] + (long long)b * J.b_stride[p] +
                      (long long)tn * 4 * kChunkBytes,
                  4 * kChunkBytes, &full[s]);
      }
    }
    return;
  }
  // consumer warpgroup cw: rows [64 (2 tk + cw), +64) of dW, its A chunk
  // (the first again, unwritten, where the layer has no second)
  const int cw = threadIdx.x >> 7;
  const bool active = cw < ka;
  const int ac = active ? cw : 0;
  const bool leader = (threadIdx.x & 31) == 0;
  float acc[128];
  fence_regs<128>(acc);
  wgmma_fence();
  int prev = -1;
  for (int i = 0; i < items; ++i) {
    const int s = i % kWSlots;
    mbar_wait(&full[s], (i / kWSlots) & 1);
    const uint32_t base = smem_addr(slots + s * kWSlotBytes);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_mn256(acc, desc_mn(base + ac * kChunkBytes + ks * 2048),
                  desc_mn(base + 2 * kChunkBytes + ks * 2048),
                  (i | ks) != 0);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs<128>(acc);
  if (leader && prev >= 0) mbar_arrive(&empty[prev]);
  if (!active) return;
  const Frag f;
  float* P = ws32 + J.part + (size_t)split * J.K * J.N;
  const int k = 64 * (2 * tk + cw) + f.row();
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int n = 256 * tn + 8 * j + 2 * f.tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + 8 * h;
      if (kk >= J.K) continue;
      if (n < J.N) P[(size_t)kk * J.N + n] = acc[4 * j + 2 * h];
      if (n + 1 < J.N) P[(size_t)kk * J.N + n + 1] = acc[4 * j + 2 * h + 1];
    }
  }
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
  err = set_smem((const void*)k4_wgrad_kernel, kWSmemBytes);
  if (err != cudaSuccess) return err;
  k4_wgrad_kernel<<<grid, kBlockThreads, kWSmemBytes, st>>>(jobs, a.scratch,
                                                            ws32);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long sum_blocks = (sums.total + kThreads - 1) / kThreads;
  sum_kernel<<<(int)(sum_blocks < 4096 ? sum_blocks : 4096), kThreads, 0,
               st>>>(sums);
  return cudaGetLastError();
}

}  // namespace
}  // namespace i2sdf

// `reg`, `script` and `jobs` (int64, device memory except `jobs`) are
// built by `i2sdf_tpu_torch/ops/kernels/render_core.py::K4Plan`; the
// plans are K3's `CoreStages` (sdf, radiance, light) and `K4Stages`'
// transposed chains (their row counts 0 without a light head). `jobs`
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
    int F, void* scratch, float* ws32, const long long* reg,
    const long long* script, int n_items, const long long* jobs, int n_jobs,
    const long long* db_host, float* out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd < 3 || n_fwd > kMaxLayers || n_tsdf != n_fwd - 2 ||
      n_rad < 1 || n_rad > kMaxLayers || n_l < 0 || n_l > kMaxLayers ||
      n_jobs > kMaxWJobs || n_fwd - 1 > kRegLayers || n_rad > kRegLayers ||
      3 + 6 * mx > 64 || 3 + 6 * md > 64)
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
  a.fwd = read_plan(fwd_desc, n_fwd);
  a.tsdf = read_plan(tsdf_desc, n_tsdf);
  a.rad = read_plan(rad_desc, n_rad);
  a.trad = read_plan(trad_desc, n_rad);
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
  wj.n = n_jobs;
  sj.n = n_jobs + 1;
  int grid = 0;
  long long total = 0;
  const long long* t = jobs;
  for (int p = 0; p < n_jobs; ++p, t += 18) {
    WJob& J = wj.j[p];
    for (int q = 0; q < 2; ++q) {
      J.a_off[q] = t[q];
      J.a_stride[q] = t[2 + q];
      J.b_off[q] = t[4 + q];
      J.b_stride[q] = t[6 + q];
    }
    J.part = t[8];
    J.pairs = (int)t[9];
    J.K = (int)t[10];
    J.N = (int)t[11];
    J.ka = (int)t[12];
    J.nblk = (int)t[13];
    J.per = (int)t[14];
    J.splits = (int)t[15];
    J.tiles_k = (J.ka + 1) / 2;
    J.tiles_n = (J.N + 255) / 256;
    J.first = grid;
    grid += J.tiles_k * J.tiles_n * J.splits;
    sj.j[p] = SumJob{ws32 + J.part, out + t[16], (long long)J.K * J.N,
                     J.splits};
    total += sj.j[p].e;
  }
  // the blocks' bias rows: db_host = [byte offset in the scratch, tb,
  // out offset]
  sj.j[n_jobs] = SumJob{(const float*)((const unsigned char*)scratch +
                                       db_host[0]),
                        out + db_host[2], db_host[1], blocks};
  sj.total = total + db_host[1];
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_l > 0 && !detach_light)
    return (int)launch<true, true>(a, blocks, wj, grid, sj, ws32, st);
  if (n_l > 0)
    return (int)launch<true, false>(a, blocks, wj, grid, sj, ws32, st);
  return (int)launch<false, false>(a, blocks, wj, grid, sj, ws32, st);
}
