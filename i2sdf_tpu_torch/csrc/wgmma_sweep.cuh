// Shared by K4 (`render_core_bwd.cu`), K6 (`rev_bwd.cu`) and K9
// (`bg_core_bwd.cu`), the backward sweeps on `wgmma_layer.cuh`: the layout of the host-built ring
// table and scratch regions, the producer that walks the table, the
// consumers' side of the ring (the shared-memory layout after the tile,
// taking and freeing items, storing the tile and staging slots, the
// stores' completion the producer waits on, the bias rows), and the
// weight-gradient products over the operand regions a sweep stores
// (`wgrad_kernel`), with their fixed-order sums.
#pragma once

#include "wgmma_layer.cuh"

namespace i2sdf {
namespace wg {

// ring table items (`render_core.K4Plan.script`, `bg_core.BgPlan.script`):
// four int64 each, [kind | base << 8, byte offset, bytes a block (added
// per block), bytes]; a stage of a layer in passes (`kItemLoad2`) is two
// copies of half the bytes, the second from the offset plus the third
// field
enum ItemKind { kItemLoad = 0, kItemStage = 1, kItemWait = 2, kItemLoad2 = 3 };
// K4: scratch, sdf, radiance, light, transposed (K6: the radiance and
// light bases unused); K9: scratch, implicit, radiance, unused, transposed
constexpr int kBases = 5;
struct Bases {
  const unsigned char* p[kBases];
};

// The scratch regions (`render_core.K4Plan.regions`, `bg_core.BgPlan`):
// byte offset of block 0's tile and bytes a block, for each kind and
// layer. K9 takes X and Dz for its implicit layers, Q for their stash of
// s, Rx and Rdz for its radiance layers.
enum RegionKind {
  kRegX = 0, kRegDz, kRegDa, kRegR,        // SDF layers' operands
  kRegQ, kRegAh, kRegDzx,                  // the SDF stash
  kRegRx, kRegRdz,                         // radiance layers' operands
  kRegLx, kRegLdz, kRegLs, kRegClg,        // the light net's
  kRegKinds
};
constexpr int kRegLayers = 16;
constexpr int kRegDb = kRegKinds * kRegLayers * 2;   // then the bias rows

// ---- the weight-gradient products (`wgrad_kernel`) ---------------------------

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



// The producer: a ring table in order (`render_core.K4Plan.script`,
// `bg_core.BgPlan.script`), a wait item spinning until the consumers have
// completed that many sweeps' stores (`stored`).
template <int kSlots>
__device__ __forceinline__ void run_script(RingN<kSlots>& r,
                                           const long long* script,
                                           int n_items, const Bases& w,
                                           volatile int* stored) {
  for (int i = 0; i < n_items; ++i) {
    const long long* it = script + 4 * i;
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
                w.p[base] + it[1] + (long long)blockIdx.x * it[2], bytes,
                &r.full[s]);
    } else if (kind == kItemLoad2) {
      const uint32_t half = (uint32_t)it[3] / 2;
      mbar_expect_tx(&r.full[s], 2 * half);
      bulk_copy(r.slot + s * kSlotBytes, w.p[base] + it[1], half,
                &r.full[s]);
      bulk_copy(r.slot + s * kSlotBytes + half, w.p[base] + it[1] + it[2],
                half, &r.full[s]);
    } else {
      mbar_arrive(&r.full[s]);   // a staging slot: handed out empty
    }
    ++r.it;
  }
}

// ---- the consumers' side of a sweep -----------------------------------------

constexpr int kPts = 64;                     // points a block
constexpr int kSlots = 5;                    // the sweep's ring
constexpr int kTChunks = 5;                  // T: 64 rows x 320 columns
constexpr int kTBytes = kTChunks * kChunkBytes;
constexpr int kWsumCols = 320;
using KRing = RingN<kSlots>;

// The consumers' state: the tile (everything else in shared memory sits
// at fixed offsets from it), the arguments (`A`, with the scratch and its
// table `reg`: regions, then the bias rows' offsets), the ring's count of
// items taken, the tile barrier's phase, the sweeps stored so far, this
// thread's warpgroup. Kept this small so the accumulators have the
// registers. Shared memory after the tile: the ring's slots and barriers,
// the tile barrier, the stored-sweeps count, the sweep's own `kRest`
// floats (`rest`: its points, directions, cotangents, rgb) and the warps'
// column sums.
template <class A, int kRest>
struct SweepCtx {
  unsigned char* T;
  const A* a;
  int it, tphase, done, cw;

  static constexpr size_t kSmemBytes =
      1024 + kTBytes + ring_bytes<kSlots>() + 16 +
      (size_t)(kRest + 4 * kWsumCols) * sizeof(float);

  __device__ __forceinline__ unsigned char* slots() const {
    return T + kTBytes;
  }
  __device__ __forceinline__ unsigned char* slot(int s) const {
    return slots() + s * kSlotBytes;
  }
  __device__ __forceinline__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(T + kTBytes + kSlots * kSlotBytes);
  }
  __device__ __forceinline__ uint64_t* empty() const {
    return full() + kSlots;
  }
  __device__ __forceinline__ unsigned char* after() const {
    return T + kTBytes + ring_bytes<kSlots>();
  }
  __device__ __forceinline__ uint64_t* tbar() const {
    return reinterpret_cast<uint64_t*>(after());
  }
  __device__ __forceinline__ volatile int* stored() const {
    return reinterpret_cast<volatile int*>(after() + 8);
  }
  __device__ __forceinline__ float* rest() const {
    return reinterpret_cast<float*>(after() + 16);
  }
  __device__ __forceinline__ float* wsum() const { return rest() + kRest; }
  // the block's bias-gradient row, weight gradient p's columns at db_off(p)
  __device__ __forceinline__ float* dbrow() const {
    return reinterpret_cast<float*>(a->scratch + a->reg[kRegDb]) +
           (size_t)blockIdx.x * a->reg[kRegDb + 1];
  }
  __device__ __forceinline__ int db_off(int p) const {
    return (int)a->reg[kRegDb + 2 + p];
  }
  // this block's tile of a region of the scratch
  __device__ __forceinline__ unsigned char* region(int kind, int l) const {
    const long long* r = a->reg + 2 * (kind * kRegLayers + l);
    return a->scratch + r[0] + (long long)blockIdx.x * r[1];
  }
};

__device__ __forceinline__ int chunks(int cols) { return (cols + 63) >> 6; }

// The next ring item, once it has landed: its slot.
template <class C>
__device__ __forceinline__ int take(C& c) {
  const int s = c.it % kSlots;
  mbar_wait(&c.full()[s], (c.it / kSlots) & 1);
  ++c.it;
  return s;
}

// A loaded item read by every consumer warp: each warp's leader frees it.
template <class C>
__device__ __forceinline__ void release(C& c, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&c.empty()[s]);
}

// T (its first `ch` chunks, written and fenced) to an operand region.
template <class C>
__device__ __forceinline__ void store_T(C& c, int kind, int l, int ch) {
  if (threadIdx.x == 0) {
    bulk_store(c.region(kind, l), c.T, (uint32_t)ch * kChunkBytes);
    bulk_commit();
  }
}

// T may be written again: its bulk store has read it.
template <class C>
__device__ __forceinline__ void wait_T(C& c) {
  if (threadIdx.x == 0) bulk_wait_read();
  bar_sync(1, kConsumers);
}

// Staging slots s (and s2 if >= 0), written and fenced, to a stash region;
// freed once the copy has read them.
template <class C>
__device__ __forceinline__ void stage_out(C& c, int s, int s2, int kind,
                                          int l, uint32_t bytes) {
  bar_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    unsigned char* dst = c.region(kind, l);
    bulk_store(dst, c.slot(s), bytes);
    if (s2 >= 0) bulk_store(dst + kSlotBytes, c.slot(s2), kSlotBytes);
    bulk_commit();
    bulk_wait_read();
    mbar_arrive_n(&c.empty()[s], kConsumerWarps);
    if (s2 >= 0) mbar_arrive_n(&c.empty()[s2], kConsumerWarps);
  }
}

// The consumers' stores so far are complete in device memory; the
// producer may bring them back (its table's waits count these).
template <class C>
__device__ __forceinline__ void sweep_done(C& c) {
  ++c.done;
  if (threadIdx.x == 0) {
    bulk_wait_all();
    __threadfence_block();
    *c.stored() = c.done;
  }
}

__device__ __forceinline__ float2 get_pair(const unsigned char* tile, int row,
                                           int col) {
  return unpack_bf16x2(
      *reinterpret_cast<const uint32_t*>(tile + act_off(row, col)));
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
template <class C>
__device__ __forceinline__ void bias_row(C& c, int off, int cols) {
  bar_sync(1, kConsumers);
  const float* w = c.wsum();
  for (int k = threadIdx.x; k < cols; k += kConsumers)
    c.dbrow()[off + k] = ((w[k] + w[kWsumCols + k]) + w[2 * kWsumCols + k]) +
                         w[3 * kWsumCols + k];
}

// A layer's products over T for this warpgroup's NW columns from col0;
// then T's bulk store has read it and both warpgroups' products have
// retired.
template <int NW, class C>
__device__ __forceinline__ void product(C& c, float* acc, const int* L,
                                        int col0) {
  KRing r{c.slots(), c.full(), c.empty(), c.it};
  products<NW, 1>(acc, nullptr, smem_addr(c.T), 0, col0, L[kK], r);
  c.it = r.it;
  wait_T(c);
}

constexpr int kWSlots = 4;
constexpr int kWSlotBytes = 6 * kChunkBytes;   // two A chunks, four B chunks
constexpr int kMaxWJobs = 24;
constexpr size_t kWSmemBytes = 1024 + kWSlots * kWSlotBytes + 2 * kWSlots * 8;

// One weight gradient (`render_core.K4Plan.jobs`, `bg_core.BgPlan.jobs`):
// dW (K x N) = sum over
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

// Every dW = A^T B over the points on wgmma with both operands MN-major
// (the transpose bits), read straight from the operand regions a sweep
// wrote: a block takes 128 rows of dW (two A chunks, one a warpgroup) by
// 256 columns (four B chunks) over one range of points, the producer
// bulk-copying each 64-point block's chunks into a four-slot ring; the
// partial sums go to device memory. `kOp` names the kernel (4: K4's, 6:
// K6's, 9: K9's) in a profile.
template <int kOp>
__global__ void __launch_bounds__(kBlockThreads, 1)
wgrad_kernel(const __grid_constant__ WJobs jobs,
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


// The jobs table (host memory, `K4Plan.jobs` / `BgPlan.jobs`): n_jobs rows
// of 18 int64 (`WJob`'s fields in order, then the job's out offset) into
// the products' jobs and the sums' (job p's partials into out, then the
// blocks' bias rows: db_host = [byte offset in the scratch, tb, out
// offset]); returns the products' grid.
inline int read_jobs(const long long* jobs, int n_jobs,
                     const long long* db_host, const void* scratch,
                     int blocks, float* ws32, float* out, WJobs& wj,
                     SumJobs& sj) {
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
  sj.j[n_jobs] = SumJob{(const float*)((const unsigned char*)scratch +
                                       db_host[0]),
                        out + db_host[2], db_host[1], blocks};
  sj.total = total + db_host[1];
  return grid;
}

// The products, then the fixed-order sums (`sum_kernel`, common.cuh).
template <int kOp>
cudaError_t launch_products(const WJobs& jobs, int grid, const SumJobs& sums,
                            const unsigned char* scratch, float* ws32,
                            cudaStream_t st) {
  cudaError_t err = set_smem((const void*)wgrad_kernel<kOp>, kWSmemBytes);
  if (err != cudaSuccess) return err;
  wgrad_kernel<kOp><<<grid, kBlockThreads, kWSmemBytes, st>>>(jobs, scratch,
                                                              ws32);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long sum_blocks = (sums.total + kThreads - 1) / kThreads;
  sum_kernel<<<(int)(sum_blocks < 4096 ? sum_blocks : 4096), kThreads, 0,
               st>>>(sums);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace i2sdf
