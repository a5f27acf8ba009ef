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
// Design: K4's, without the second order. The TPU kernel carries dW in
// its output blocks from one grid step to the next; on the H100 blocks run
// in parallel, so the work is split as in K4 (`common.cuh`):
//   1. a sweep kernel, 32 points a block: the forward recomputed (the
//      stash K8 could write would cost as many bytes as it saves flops),
//      each layer's input X_l staged in bf16 in device memory and each
//      hidden implicit layer's s = softplus100'(z) in the place its dz
//      will take; sigmoid's cotangent at the radiance output; the
//      radiance net backward through its transposed layers (the ReLU
//      mask read back from the stored inputs), whose first layer gives the
//      features' cotangent, joined by c_sigma in the implicit output
//      layer's dz; the implicit net backward (dz_{l-1} = (dz_l W_l^T) s,
//      the skip's encoding columns dropped and its 1/sqrt(2) applied);
//      each layer's dz staged in bf16 and each block's bias rows in f32;
//   2. the split-K products dW_l = X_l^T dz_l over the points;
//   3. the fixed-order sums of the products' partials and the blocks'
//      bias rows: no atomics, the same result to the bit run to run.
// The chain rule to weight norm's (v, g) stays in PyTorch, outside.
#include "bg_common.cuh"

namespace i2sdf {
namespace {

// Where the sweep stages each layer's operands (element pointers into the
// bf16 and f32 scratch), as the host's table lays them out
// (i2sdf_tpu_torch/ops/kernels/bg_core.py::_BgBwdPlan).
struct BgScratch {
  __nv_bfloat16* x[kMaxLayers];   // (np, K_l): implicit layer inputs
  __nv_bfloat16* dz[kMaxLayers];  // (np, N_l): their output cotangents (a
                                  // hidden layer's s until dz replaces it)
  __nv_bfloat16* rx[kMaxRad];     // (np, K_l): radiance layer inputs
  __nv_bfloat16* rdz[kMaxRad];    // (np, N_l): their output cotangents
  float* dbpart;                  // (blocks, tb): bias-gradient rows
  int tb;
  int db[kMaxLayers + kMaxRad];   // each layer's bias row offset
};

inline size_t bg_bwd_smem_bytes(int lda, int d_in) {
  return 2 * (size_t)kSweepRows * lda * sizeof(__nv_bfloat16) +
         (size_t)kSweepRows * (d_in + 3 + 4 + 4 + lda) * sizeof(float);
}

// A hidden implicit layer: bf16(scale * softplus100(acc + b)) to shared
// memory, and s = softplus100'(acc + b) to the layer's dz staging.
struct EpiStashS {
  __nv_bfloat16* out;
  int lda;
  const float* bias;
  float scale;
  __nv_bfloat16* s;
  int lds, row0;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float z0 = v0 + bias[c], z1 = v1 + bias[c + 1];
    put2(out + r * lda + c, softplus100(z0) * scale, softplus100(z1) * scale);
    put2(s + (size_t)(row0 + r) * lds + c, dsoftplus100(z0),
         dsoftplus100(z1));
  }
};

// Implicit backward through W_l^T (its rows cut to the hidden part of the
// layer's input): dz_{l-1} = scale * v * s_{l-1} on the first n_h columns,
// zero on the padding; s read from the layer's dz staging and dz written
// back in its place, bf16 to shared memory, f32 to dzf for the bias sums.
struct EpiBgBack {
  __nv_bfloat16* out;
  int lda;
  __nv_bfloat16* dz;
  int ldz, row0;
  float* dzf;
  float scale;
  int n_h;
  __device__ __forceinline__ float one(int r, int c, float v) {
    const float d =
        c < n_h ? v * scale * bf(dz + (size_t)(row0 + r) * ldz + c) : 0.f;
    dzf[r * lda + c] = d;
    return d;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1) {
    const float d0 = one(r, c, v0), d1 = one(r, c + 1, v1);
    put2(out + r * lda + c, d0, d1);
    put2(dz + (size_t)(row0 + r) * ldz + c, d0, d1);
  }
};

// The sweep (see the header), 32 points a block. cot rows are
// [c_sigma | c_rgb (3)]. `pit` holds the implicit layers n_i-1 .. 1
// transposed, `prt` the radiance layers n_r-1 .. 0 (layer 0 cut to the
// feature rows).
__global__ void __launch_bounds__(kThreads)
bg_bwd_sweep_kernel(const float* __restrict__ x4,
                    const float* __restrict__ dirs,
                    const float* __restrict__ cot, int n,
                    const uint2* __restrict__ wi,
                    const float* __restrict__ bi, Plan pi,
                    const uint2* __restrict__ wit, Plan pit,
                    const uint2* __restrict__ wr,
                    const float* __restrict__ br, Plan pr,
                    const uint2* __restrict__ wrt, Plan prt, int d_in,
                    int fx, int fv, int F, int lda, BgScratch sc) {
  constexpr int kMT = kSweepMT, kMaxNT = kSweepMaxNT, kRows = kSweepRows;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* buf[2];
  buf[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  buf[1] = buf[0] + kRows * lda;
  float* xs = reinterpret_cast<float*>(buf[1] + kRows * lda);
  float* ds = xs + kRows * d_in;
  float* ct = ds + kRows * 3;
  float* rgb = ct + kRows * 4;
  float* dzf = rgb + kRows * 4;
  const int ni = pi.n, nr = pr.n;
  const int row0 = blockIdx.x * kRows;
  float* dbp = sc.dbpart + (size_t)blockIdx.x * sc.tb;

  load_points(xs, x4, d_in, kRows, row0, n);
  load_points(ds, dirs, 3, kRows, row0, n);
  load_points(ct, cot, 4, kRows, row0, n);
  __syncthreads();
  write_pe_d(buf[0], lda, kRows, xs, d_in, fx, 0, pi.L[0][kK], 1.f);
  __syncthreads();

  // ---- 1. implicit forward: X_l to x[l], s_l to dz[l] --------------------
  int cur = 0;
  for (int l = 0; l < ni; ++l) {
    const int* L = pi.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe_d(buf[cur], lda, kRows, xs, d_in, fx, L[kCol], L[kK],
                 kInvSqrt2);
      __syncthreads();
    }
    store_rows(buf[cur], lda, sc.x[l], L[kK], L[kK], row0);
    const uint2* W = wi + L[kWOff];
    const float* b = bi + L[kBOff];
    if (l < ni - 1) {
      EpiStashS epi{buf[cur ^ 1], lda, b,
                    (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, sc.dz[l], L[kN],
                    row0};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiFeat epi{buf[cur ^ 1], lda, b, F};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- 2. radiance forward: X_l to rx[l], rgb to shared memory ----------
  write_pe_d(buf[cur], lda, kRows, ds, 3, fv, F, pr.L[0][kK], 1.f);
  __syncthreads();
  for (int l = 0; l < nr; ++l) {
    const int* L = pr.L[l];
    store_rows(buf[cur], lda, sc.rx[l], L[kK], L[kK], row0);
    const uint2* W = wr + L[kWOff];
    const float* b = br + L[kBOff];
    if (l < nr - 1) {
      EpiRelu epi{buf[cur ^ 1], lda, b};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    } else {
      EpiRgbShared epi{rgb, b, L[kReal]};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- 3. the radiance output's dz = c_rgb rgb (1 - rgb) ----------------
  {
    const int N = pr.L[nr - 1][kN], d_out = pr.L[nr - 1][kReal];
    for (int i = threadIdx.x; i < kRows * N; i += kThreads) {
      const int r = i / N, c = i % N;
      float v = 0.f;
      if (c < d_out) {
        const float g = rgb[r * 4 + c];
        v = ct[r * 4 + 1 + c] * g * (1.f - g);
      }
      dzf[r * lda + c] = v;
      buf[cur][r * lda + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    store_rows(buf[cur], lda, sc.rdz[nr - 1], N, N, row0);
    put_db(dbp + sc.db[ni + nr - 1], dzf, lda, N);
    __syncthreads();
  }

  // ---- 4. radiance backward; its first layer gives the features' dz ------
  const int n_last = pi.L[ni - 1][kN];
  __nv_bfloat16* cy = sc.dz[ni - 1];
  for (int l = nr - 1; l >= 0; --l) {
    const int* L = prt.L[nr - 1 - l];  // W_l^T
    const uint2* W = wrt + L[kWOff];
    if (l > 0) {
      EpiRadBack epi{buf[cur ^ 1], lda, sc.rx[l], L[kN], row0, dzf};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
      __syncthreads();
      const int N = pr.L[l - 1][kN];
      store_rows(buf[cur ^ 1], lda, sc.rdz[l - 1], N, N, row0);
      put_db(dbp + sc.db[ni + l - 1], dzf, lda, N);
      __syncthreads();
      cur ^= 1;
    } else {
      EpiFeatCot epi{cy, n_last, row0, F, dzf, lda};
      mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], W, L[kN], epi);
      // the sigma column carries c_sigma; padding columns are zero
      for (int i = threadIdx.x; i < kRows * (n_last - F); i += kThreads) {
        const int r = i / (n_last - F), c = F + i % (n_last - F);
        const float v = c == F ? ct[r * 4] : 0.f;
        cy[(size_t)(row0 + r) * n_last + c] = __float2bfloat16_rn(v);
        dzf[r * lda + c] = v;
      }
      __syncthreads();
      put_db(dbp + sc.db[ni - 1], dzf, lda, n_last);
      __syncthreads();
    }
  }

  // ---- 5. implicit backward: dz_{l-1} to dz[l-1] in place of s_{l-1} -----
  load_rows(buf[cur], lda, cy, n_last, n_last, row0);
  __syncthreads();
  for (int l = ni - 1; l >= 1; --l) {
    const int* L = pit.L[ni - 1 - l];  // W_l^T, rows cut to the hidden part
    const int N = pi.L[l - 1][kN];
    EpiBgBack epi{buf[cur ^ 1], lda, sc.dz[l - 1], N, row0, dzf,
                  (L[kFlags] & kScale) ? kInvSqrt2 : 1.f, L[kReal]};
    mma_layer<kMT, kMaxNT>(buf[cur], lda, L[kK], wit + L[kWOff], L[kN], epi);
    __syncthreads();
    put_db(dbp + sc.db[l - 1], dzf, lda, N);
    __syncthreads();
    cur ^= 1;
  }
}

}  // namespace
}  // namespace i2sdf

// The table (int64, element offsets into ws16 / ws32 and out), in the
// order `_BgBwdPlan` writes it: x, dz (implicit layers), rx, rdz
// (radiance layers), dbpart, tb, the bias row offsets, then per product
// (implicit layers, then radiance layers) its splits, chunk, partials and
// output offset, and last the bias gradients' offset in `out`.
extern "C" int i2sdf_bg_core_bwd(
    const float* x4, const float* dirs, const float* cot, int n, int np,
    const void* wi, const float* bi, const int* plan_i, int n_i,
    const void* wit, const int* plan_it, const void* wr, const float* br,
    const int* plan_r, int n_r, const void* wrt, const int* plan_rt,
    int d_in, int fx, int fv, int F, int lda, void* ws16, float* ws32,
    const long long* table, float* out, void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  const int jobs_n = n_i + n_r;
  if (n_i < 2 || n_i > kMaxLayers || n_r < 1 || n_r > kMaxRad ||
      jobs_n > kMaxJobs || np % kSweepRows != 0)
    return (int)cudaErrorInvalidValue;
  const Plan pi = read_plan(plan_i, n_i), pit = read_plan(plan_it, n_i - 1);
  const Plan pr = read_plan(plan_r, n_r), prt = read_plan(plan_rt, n_r);
  __nv_bfloat16* b16 = (__nv_bfloat16*)ws16;
  BgScratch sc;
  const long long* t = table;
  for (int l = 0; l < n_i; ++l) sc.x[l] = b16 + *t++;
  for (int l = 0; l < n_i; ++l) sc.dz[l] = b16 + *t++;
  for (int l = 0; l < n_r; ++l) sc.rx[l] = b16 + *t++;
  for (int l = 0; l < n_r; ++l) sc.rdz[l] = b16 + *t++;
  sc.dbpart = ws32 + *t++;
  sc.tb = (int)*t++;
  for (int p = 0; p < jobs_n; ++p) sc.db[p] = (int)*t++;
  const long long* splits = t;
  const long long* chunk = t + jobs_n;
  const long long* part = t + 2 * jobs_n;
  const long long* outp = t + 3 * jobs_n;
  const long long out_db = t[4 * jobs_n];

  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = bg_bwd_smem_bytes(lda, d_in);
  cudaError_t err = set_smem((const void*)bg_bwd_sweep_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = np / kSweepRows;
  bg_bwd_sweep_kernel<<<blocks, kThreads, smem, st>>>(
      x4, dirs, cot, n, (const uint2*)wi, bi, pi, (const uint2*)wit, pit,
      (const uint2*)wr, br, pr, (const uint2*)wrt, prt, d_in, fx, fv, F, lda,
      sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the weight gradients: X_l^T dz_l over np rows, split, then summed
  GemmJobs gj;
  SumJobs sj;
  gj.n = jobs_n;
  sj.n = jobs_n + 1;
  int gemm_blocks = 0;
  long long total = 0;
  for (int p = 0; p < jobs_n; ++p) {
    const bool imp = p < n_i;
    const int* L = imp ? pi.L[p] : pr.L[p - n_i];
    GemmJob& J = gj.j[p];
    J.a = imp ? sc.x[p] : sc.rx[p - n_i];
    J.b = imp ? sc.dz[p] : sc.rdz[p - n_i];
    J.part = ws32 + part[p];
    J.m = np;
    J.k = L[kK];
    J.n = L[kN];
    J.chunk = (int)chunk[p];
    J.tiles_k = (J.k + kTK - 1) / kTK;
    J.tiles_n = (J.n + kTN - 1) / kTN;
    J.blocks = J.tiles_k * J.tiles_n * (int)splits[p];
    gemm_blocks += J.blocks;
    sj.j[p] = SumJob{J.part, out + outp[p], (long long)J.k * J.n,
                     (int)splits[p]};
    total += sj.j[p].e;
  }
  sj.j[jobs_n] = SumJob{sc.dbpart, out + out_db, (long long)sc.tb, blocks};
  sj.total = total + sc.tb;
  atb_kernel<<<gemm_blocks, kThreads, 0, st>>>(gj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long sum_blocks = (sj.total + kThreads - 1) / kThreads;
  sum_kernel<<<(int)(sum_blocks < 4096 ? sum_blocks : 4096), kThreads, 0,
               st>>>(sj);
  return (int)cudaGetLastError();
}
