// K12 sdf_grad_bwd: the backward of K11, the gradients of <c_out, [sdf |
// features]> + <c_g, grad> with respect to every weight and bias of the
// SDF net, through the spatial gradient (second-order terms included),
// by the tangent streams.
//
// Replaces the backward of the TPU kernel `i2sdf_tpu/ops/pallas/
// fused_grad.py:250 get_sdf_outputs_op` (pallas_call at :323, body
// `_make_bwd_kernel` at :140-225; the math in the docstring at :9-22).
// Like the TPU op it gives no cotangent to x (:347).
//
// What bounds it on the H100: operations. At the flagship config a point
// costs the tangent sweep through the hidden layers again (four streams),
// the four streams back through the hidden layers transposed, its share
// of the hidden layers' weight-gradient products over the four streams,
// and the output layer's transposed and weight-gradient products for the
// primal row plus a rank-3 term each, ~11.2 M bf16 flops
// (`chip_smoke.py::k12_macs`), against 1,052 bytes in (x, c_out, c_g).
//
// The math, per layer in reverse (z = h W + b, s = softplus'(z), t_k the
// layer's input tangents, T_k = scale * s * (t_k W) the next layer's):
//   dz    = scale * s * dh + 100 (1 - s) * sum_k r_k T_k
//   rho_k = scale * s * r_k
//   dW   += [h ; t_0 ; t_1 ; t_2]^T [dz ; rho_0 ; rho_1 ; rho_2]
//   db   += sum dz;   dh_in = dz W^T,   r_k,in = rho_k W^T
// (scale * d softplus'/dz * (t_k W) = 100 (1 - s) T_k), the skip's
// encoding share of dh_in and r_k,in dropped (x is a constant), its
// hidden share scaled by 1/sqrt(2). The output layer's dz is c_out and its
// rho_k is c_g[k] in the sdf column alone, so its tangent rows take no
// matrix product: their r_k,in is c_g[k] times that column of W (rank 1),
// and their share of dW is c_g[k] t_k in that column (rank 3 a point).
//
// Design: K4's machinery (`csrc/common.cuh`) for the weight gradients,
// which sum over every point. One launch of `tangent_bwd_kernel`, 16
// points a block with the four streams stacked as 64 rows (K10's
// `tangent_layer`): the forward sweep staging each layer's input [h ; t]
// in bf16 in device memory and each hidden layer's stash q =
// sigmoid(-|100 z|) with z's sign in shared memory (`stash_q`: 1 - s keeps
// bf16's relative precision); then the reverse sweep through the
// transposed layers, whose epilogue reads q and the staged T_k (device
// memory, recently written, from L2) and stages [dz ; rho] in bf16; the
// bias rows, and the output layer's rank-3 column, summed over the
// block's points in f32 in order. Then the split-K A^T B products over
// 4 np rows (np in the output layer) and the fixed-order sums
// (`launch_wgrad`): no atomics, the same bits run to run. There is no
// reverse sweep of the primal to keep (K6's stash of d sdf / d h, its
// upward and downward sweeps): the tangents carry the spatial gradient.
#include "tangent_common.cuh"

namespace i2sdf {

// Shared memory of `tangent_bwd_kernel` (bytes): two activation buffers
// of the four streams, every hidden layer's stash q, the f32 dz the bias
// sums take, and per point x and c_g (the host mirrors it in
// `sdf_grad.bwd_smem`).
inline size_t tan_bwd_smem_bytes(int lda, int ldd, int n_q) {
  return (2 * (size_t)kTanRows * lda + (size_t)n_q * kTanPoints * ldd) *
             sizeof(__nv_bfloat16) +
         (size_t)kTanPoints * (lda + 3 + 3) * sizeof(float);
}

// Copy `cols` (a multiple of 8) columns of the first `streams` streams'
// rows from shared memory (row stride lda) to their staging in device
// memory (row stride cols): stream s of point p to row s * np + row0 + p.
__device__ __forceinline__ void store_streams(const __nv_bfloat16* s,
                                              int lda, __nv_bfloat16* g,
                                              int np, int cols, int row0,
                                              int streams) {
  const int v = cols >> 3;
  for (int i = threadIdx.x; i < streams * kTanPoints * v; i += kThreads) {
    const int r = i / v, c = (i % v) << 3;
    const int row = (r / kTanPoints) * np + row0 + r % kTanPoints;
    *reinterpret_cast<uint4*>(g + (size_t)row * cols + c) =
        *reinterpret_cast<const uint4*>(s + r * lda + c);
  }
}

// The block's bias-gradient row: column c summed over its points in order.
__device__ __forceinline__ void put_db_points(float* dst, const float* dzf,
                                              int lda, int n) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < kTanPoints; ++p) acc += dzf[p * lda + c];
    dst[c] = acc;
  }
}

// The transposed layer W_l^T's epilogue: v[0] = dL/dh and v[1 + k] =
// dL/dt_k at input column c of layer l, which is output column c of layer
// l - 1 below n_h (the hidden width that continues down the net). Writes
// [dz ; rho_0 ; rho_1 ; rho_2] of layer l - 1 in bf16 to `out` (zero from
// n_h on) and dz in f32 to `dzf`; `q` is layer l - 1's stash, `tin` layer
// l's staged input (4 np rows of ldt), whose tangent rows are the T_k.
struct EpiTanBack {
  __nv_bfloat16* out;
  int lda;
  const __nv_bfloat16* q;
  int ldd;
  const __nv_bfloat16* tin;
  int ldt, np, row0, n_h;
  float scale;
  float* dzf;
  __device__ __forceinline__ void operator()(int p, int c,
                                             const float (&v)[kStreams][2]) {
    float dz[2], rho[kStreams - 1][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c + e;
      dz[e] = 0.f;
#pragma unroll
      for (int k = 0; k < kStreams - 1; ++k) rho[k][e] = 0.f;
      if (col >= n_h) continue;
      const float qv = bf(q + p * ldd + col);
      const float s = stash_s(qv) * scale;
      const float oms = signbit(qv) ? fabsf(qv) : 1.f - qv;  // 1 - s
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kStreams - 1; ++k) {
        const size_t row = (size_t)(k + 1) * np + row0 + p;
        sum += v[k + 1][e] * bf(tin + row * ldt + col);
        rho[k][e] = s * v[k + 1][e];
      }
      dz[e] = s * v[0][e] + 100.f * oms * sum;
    }
    put2(out + p * lda + c, dz[0], dz[1]);
#pragma unroll
    for (int k = 0; k < kStreams - 1; ++k)
      put2(out + ((k + 1) * kTanPoints + p) * lda + c, rho[k][0], rho[k][1]);
    dzf[p * lda + c] = dz[0];
    dzf[p * lda + c + 1] = dz[1];
  }
};

// The output layer's transposed product takes the primal rows alone
// (`mma_layer`, v0 and v1 = dL/dh); the tangent rows' dL/dt_k are c_g[k]
// times the sdf column of W (`wsdf`, bf16 values), handed with them to
// EpiTanBack.
struct EpiSdfColBack {
  EpiTanBack& back;
  const float* cg;
  const float* wsdf;
  __device__ __forceinline__ void operator()(int p, int c, float v0,
                                             float v1) {
    float v[kStreams][2];
    v[0][0] = v0;
    v[0][1] = v1;
    const float w0 = __ldg(wsdf + c), w1 = __ldg(wsdf + c + 1);
#pragma unroll
    for (int k = 0; k < kStreams - 1; ++k) {
      v[k + 1][0] = cg[p * 3 + k] * w0;
      v[k + 1][1] = cg[p * 3 + k] * w1;
    }
    back(p, c, v);
  }
};

namespace {

__global__ void __launch_bounds__(kThreads)
tangent_bwd_kernel(const float* __restrict__ x,
                   const float* __restrict__ c_out, int out_cols,
                   const float* __restrict__ c_g, int n,
                   const uint2* __restrict__ w_fwd,
                   const float* __restrict__ b_sdf, Plan fwd,
                   const uint2* __restrict__ w_t, Plan tp,
                   const float* __restrict__ wsdf, int mx, int lda, int ldd,
                   Scratch sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = fwd.n, nh = ns - 1;
  __nv_bfloat16* buf[2];
  buf[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  buf[1] = buf[0] + kTanRows * lda;
  __nv_bfloat16* q = buf[1] + kTanRows * lda;
  float* dzf = reinterpret_cast<float*>(q + (size_t)nh * kTanPoints * ldd);
  float* xs = dzf + kTanPoints * lda;
  float* cg = xs + kTanPoints * 3;
  const int row0 = blockIdx.x * kTanPoints, np = sc.np;
  float* dbp = sc.dbpart + (size_t)blockIdx.x * sc.tb;

  for (int i = threadIdx.x; i < kTanPoints * 3; i += kThreads) {
    const int r = row0 + i / 3;
    xs[i] = r < n ? x[(size_t)r * 3 + i % 3] : 0.f;
    cg[i] = r < n ? c_g[(size_t)r * 3 + i % 3] : 0.f;
  }
  __syncthreads();
  write_pe4(buf[0], lda, xs, mx, 0, fwd.L[0][kK], 1.f);
  __syncthreads();

  // ---- 1. the tangent sweep: each layer's input to ax[l], stash q_l -----
  int cur = 0;
  for (int l = 0; l < ns; ++l) {
    const int* L = fwd.L[l];
    if (L[kFlags] & kSkipIn) {
      write_pe4(buf[cur], lda, xs, mx, L[kCol], L[kK], kInvSqrt2);
      __syncthreads();
    }
    store_streams(buf[cur], lda, sc.ax[l], np, L[kK], row0, kStreams);
    if (l < nh) {
      EpiTangent epi{buf[cur ^ 1], lda, b_sdf + L[kBOff],
                     (L[kFlags] & kScale) ? kInvSqrt2 : 1.f,
                     q + (size_t)l * kTanPoints * ldd, ldd};
      tangent_layer(buf[cur], lda, L[kK], w_fwd + L[kWOff], L[kN], epi);
      __syncthreads();
      cur ^= 1;
    }
  }
  __syncthreads();

  // ---- 2. the output layer: dz = c_out; the block's rank-3 share of its
  // sdf column, sum_p sum_k c_g[k] t_k, after the bias rows ---------------
  {
    const int N = fwd.L[nh][kN], K = fwd.L[nh][kK];
    for (int c = threadIdx.x; c < K; c += kThreads) {
      float acc = 0.f;
      for (int p = 0; p < kTanPoints; ++p)
#pragma unroll
        for (int k = 0; k < kStreams - 1; ++k)
          acc += cg[p * 3 + k] *
                 bf(buf[cur] + ((k + 1) * kTanPoints + p) * lda + c);
      dbp[sc.db_sdf[nh] + N + c] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTanPoints * N; i += kThreads) {
      const int p = i / N, c = i % N;
      const float v = row0 + p < n && c < out_cols
                          ? c_out[(size_t)(row0 + p) * out_cols + c]
                          : 0.f;
      dzf[p * lda + c] = v;
      buf[cur][p * lda + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    store_streams(buf[cur], lda, sc.br[nh], np, N, row0, 1);
    put_db_points(dbp + sc.db_sdf[nh], dzf, lda, N);
    __syncthreads();
  }

  // ---- 3. the reverse sweep: [dz ; rho] of layer l - 1 to br[l - 1] ------
  for (int l = nh; l >= 1; --l) {
    const int* L = tp.L[nh - l];  // W_l^T
    const int N = fwd.L[l - 1][kN];
    EpiTanBack epi{buf[cur ^ 1],
                   lda,
                   q + (size_t)(l - 1) * kTanPoints * ldd,
                   ldd,
                   sc.ax[l],
                   fwd.L[l][kK],
                   np,
                   row0,
                   L[kReal],
                   (L[kFlags] & kScale) ? kInvSqrt2 : 1.f,
                   dzf};
    if (l == nh) {
      EpiSdfColBack eo{epi, cg, wsdf};
      mma_layer<1, kTanMaxNT>(buf[cur], lda, L[kK], w_t + L[kWOff], L[kN],
                              eo);
    } else {
      tangent_layer(buf[cur], lda, L[kK], w_t + L[kWOff], L[kN], epi);
    }
    __syncthreads();
    store_streams(buf[cur ^ 1], lda, sc.br[l - 1], np, N, row0, kStreams);
    put_db_points(dbp + sc.db_sdf[l - 1], dzf, lda, N);
    __syncthreads();
    cur ^= 1;
  }
}

}  // namespace

}  // namespace i2sdf

// The scratch table (int64, element offsets) is built by
// `i2sdf_tpu_torch/ops/kernels/render_core.py::_BwdPlan` (as
// `sdf_grad.bwd_plan` asks for it: four streams, no second-order stash,
// the rank-3 column after the bias rows, no radiance or light layers) and
// read in the same order by `read_scratch`; `wsdf` is the output layer's
// sdf column (`sdf_grad.SdfGradLayout.wsdf_col`).
extern "C" int i2sdf_sdf_grad_bwd(const float* x, const float* c_out,
                                  const float* c_g, int n, int np,
                                  int out_cols, const void* w_fwd,
                                  const float* b_sdf, const int* fwd_desc,
                                  int n_fwd, const void* w_t,
                                  const int* t_desc, int n_t,
                                  const float* wsdf, int mx, int lda, int ldd,
                                  void* ws16, float* ws32,
                                  const long long* table, float* out,
                                  void* stream) {
  using namespace i2sdf;
  if (n <= 0) return 0;
  if (n_fwd > kMaxSdf || n_t != n_fwd || n_fwd < 2 || np % kTanPoints)
    return (int)cudaErrorInvalidValue;
  const Plan fwd = read_plan(fwd_desc, n_fwd), tp = read_plan(t_desc, n_t);
  Scratch sc;
  const long long* rest = read_scratch(table, n_fwd, np, ws16, ws32, sc);
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = tan_bwd_smem_bytes(lda, ldd, n_fwd - 1);
  cudaError_t err = set_smem((const void*)tangent_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tangent_bwd_kernel<<<np / kTanPoints, kThreads, smem, st>>>(
      x, c_out, out_cols, c_g, n, (const uint2*)w_fwd, b_sdf, fwd,
      (const uint2*)w_t, tp, wsdf, mx, lda, ldd, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad(fwd, sc, rest, ws32, out, st, kStreams,
                           kTanPoints, 1);
}
