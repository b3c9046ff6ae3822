// Backward of the pairwise attention pool (B4's function):
//   s = x (+ residual, added in x's type), per pair p:
//   d = s[2p] - s[2p+1] (f32), ld = T(d) @ W, wgt = sigmoid(ld),
//   out = s[2p+1] + d * wgt
// (an odd L pools its last row alone, with wgt forced to 1). Given the
// output cotangent ct:
//   dld = ct * d * wgt * (1 - wgt)          (0 at the odd tail)
//   dx0 = ct * wgt + T(dld) @ W^T,  dx1 = ct - dx0
//   dW  = T(d)^T @ T(dld)                   (summed over every pair)
// and d residual is the same tensor as dx. At the odd tail dx0 = ct.
//
// Replaces svdd_tpu/ops/attn_pool_pallas.py:attn_pool_wlogits_bwd_pallas
// (pallas_call at :523, body _wl_bwd_kernel :414, formulas :417-423).
//
// What bounds it on an H100: three C x C products over the N*ceil(L/2)
// pairs (the recomputed logits, the dgrad and the wgrad), 6*N*LH*C*C
// flops, on the f32 FMA pipes; at the stem pool (512, 200, 768) that
// is 181 GFLOP, 2.7 ms at the 67 TFLOP/s published f32 peak, against
// 0.55 GB of x, residual, ct and dx (0.16 ms at 3.35 TB/s). Design:
// the 128x128-tile GEMM of gemm.cuh, three times:
//  1. the forward's pair-difference GEMM (the same stage loads as
//     attn_pool.cu), whose epilogue writes wgt (f32) and T(dld);
//  2. T(dld) @ W^T, whose epilogue blends dx0 and dx1 into dx;
//  3. per (128x128 tile of W, chunk of pairs) T(d)^T @ T(dld), with d
//     rebuilt from x in the stage loads; a deterministic second pass
//     sums the chunk partials (gemm.cuh reduce) in place of the TPU's
//     sequential-grid accumulator.
#include "gemm.cuh"

namespace {

using svdd::kBK;
using svdd::kBM;
using svdd::kBN;
using svdd::load4;
using svdd::store4;

template <typename T, bool HAS_RES>
__device__ __forceinline__ void load_s4(const T* __restrict__ x,
                                        const T* __restrict__ res, size_t i,
                                        float* s) {
  load4<T>(x + i, s);
  if (HAS_RES) {
    float r[4];
    load4<T>(res + i, r);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = svdd::round_to<T>(s[e] + r[e]);
  }
}

// Pair geometry of pooled row `row` (a flat (n, p) index).
struct Pair {
  size_t base;  // offset of s[n, 2p, 0]
  bool pair;    // 2p + 1 < L
  bool tail;    // L odd and p the last pair
};

__device__ __forceinline__ Pair pair_of(long long row, int L, int lh, int C) {
  const long long nn = row / lh;
  const int p = static_cast<int>(row - nn * lh);
  Pair q;
  q.base = (static_cast<size_t>(nn) * L + 2 * p) * C;
  q.pair = 2 * p + 1 < L;
  q.tail = (L & 1) && p == lh - 1;
  return q;
}

// T(d) at 4 consecutive channels of one pair
template <typename T, bool HAS_RES>
__device__ __forceinline__ void load_d4(const T* __restrict__ x,
                                        const T* __restrict__ res,
                                        const Pair& q, int C, int ch,
                                        float* d) {
  float s0[4], s1[4] = {0.f, 0.f, 0.f, 0.f};
  load_s4<T, HAS_RES>(x, res, q.base + ch, s0);
  if (q.pair) load_s4<T, HAS_RES>(x, res, q.base + C + ch, s1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = svdd::round_to<T>(s0[e] - s1[e]);
}

// 1. logits recomputed; wgt and T(dld) written per (pair, channel)
template <typename T, bool HAS_RES>
__global__ void __launch_bounds__(svdd::kGemmThreads, 2)
    pool_bwd_logits_kernel(const T* __restrict__ x, const T* __restrict__ res,
                           const T* __restrict__ w, const T* __restrict__ ct,
                           float* __restrict__ wgt_out, T* __restrict__ dld_out,
                           int N, int L, int C) {
  __shared__ __align__(16) svdd::GemmSmem sm;
  const int lh = (L + 1) / 2;
  const long long rows = static_cast<long long>(N) * lh;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const svdd::StageCoords sc = svdd::stage_coords<svdd::ALayout::KMajor>(tid);
  const bool a_valid = m0 + sc.a_m < rows;
  const Pair aq = pair_of(a_valid ? m0 + sc.a_m : 0, L, lh, C);
  auto load_stage = [&](int s, float* a_reg, float* b_reg) {
    const int k0 = s * kBK;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_reg[e] = 0.f;
    if (a_valid) load_d4<T, HAS_RES>(x, res, aq, C, k0 + sc.a_k, a_reg);
    load4<T>(w + static_cast<size_t>(k0 + sc.b_k) * C + n0 + sc.b_n, b_reg);
  };
  float acc[8][8];
  svdd::gemm_tile<svdd::ALayout::KMajor>(sm, C / kBK, load_stage, acc);

  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + svdd::acc_row(i, ty);
    if (row >= rows) continue;
    const Pair q = pair_of(row, L, lh, C);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      float s0[4], s1[4] = {0.f, 0.f, 0.f, 0.f}, c[4], wg[4], dl[4];
      load_s4<T, HAS_RES>(x, res, q.base + col, s0);
      if (q.pair) load_s4<T, HAS_RES>(x, res, q.base + C + col, s1);
      const size_t at = static_cast<size_t>(row) * C + col;
      load4<T>(ct + at, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = s0[e] - s1[e];
        wg[e] = q.tail ? 1.f : svdd::sigmoid(acc[i][g * 4 + e]);
        dl[e] = q.tail ? 0.f : c[e] * d * wg[e] * (1.f - wg[e]);
      }
      store4<float>(wgt_out + at, wg);
      store4<T>(dld_out + at, dl);
    }
  }
}

// 2. dx0 = ct * wgt + T(dld) @ W^T, dx1 = ct - dx0
template <typename T>
__global__ void __launch_bounds__(svdd::kGemmThreads, 2)
    pool_bwd_dgrad_kernel(const T* __restrict__ dld, const T* __restrict__ wtr,
                          const T* __restrict__ ct,
                          const float* __restrict__ wgt, T* __restrict__ dx,
                          int N, int L, int C) {
  __shared__ __align__(16) svdd::GemmSmem sm;
  const int lh = (L + 1) / 2;
  const long long rows = static_cast<long long>(N) * lh;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const svdd::StageCoords sc = svdd::stage_coords<svdd::ALayout::KMajor>(tid);
  const bool a_valid = m0 + sc.a_m < rows;
  const size_t a_base = static_cast<size_t>(a_valid ? m0 + sc.a_m : 0) * C;
  auto load_stage = [&](int s, float* a_reg, float* b_reg) {
    const int k0 = s * kBK;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_reg[e] = 0.f;
    if (a_valid) load4<T>(dld + a_base + k0 + sc.a_k, a_reg);
    load4<T>(wtr + static_cast<size_t>(k0 + sc.b_k) * C + n0 + sc.b_n, b_reg);
  };
  float acc[8][8];
  svdd::gemm_tile<svdd::ALayout::KMajor>(sm, C / kBK, load_stage, acc);

  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + svdd::acc_row(i, ty);
    if (row >= rows) continue;
    const Pair q = pair_of(row, L, lh, C);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      const size_t at = static_cast<size_t>(row) * C + col;
      float c[4], wg[4], d0[4], d1[4];
      load4<T>(ct + at, c);
      load4<float>(wgt + at, wg);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d0[e] = c[e] * wg[e] + acc[i][g * 4 + e];
        d1[e] = c[e] - d0[e];
      }
      store4<T>(dx + q.base + col, d0);
      if (q.pair) store4<T>(dx + q.base + C + col, d1);
    }
  }
}

// 3. dW[a0.., b0..] partial over pairs [chunk * rows_per_chunk, ...)
template <typename T, bool HAS_RES>
__global__ void __launch_bounds__(svdd::kGemmThreads, 2)
    pool_bwd_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const T* __restrict__ dld,
                          float* __restrict__ dw_part, int N, int L, int C,
                          int rows_per_chunk) {
  __shared__ __align__(16) svdd::GemmSmem sm;
  const int tiles_b = C / kBN;
  const int a0 = (blockIdx.x / tiles_b) * kBM;
  const int b0 = (blockIdx.x % tiles_b) * kBN;
  const int chunk = blockIdx.y;
  const int lh = (L + 1) / 2;
  const long long total = static_cast<long long>(N) * lh;
  const long long r_begin = static_cast<long long>(chunk) * rows_per_chunk;
  const long long r_end = min(total, r_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const svdd::StageCoords sc = svdd::stage_coords<svdd::ALayout::MMajor>(tid);
  auto load_stage = [&](int s, float* a_reg, float* b_reg) {
    const long long r = r_begin + static_cast<long long>(s) * kBK + sc.a_k;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_reg[e] = b_reg[e] = 0.f;
    if (r >= r_end) return;
    load_d4<T, HAS_RES>(x, res, pair_of(r, L, lh, C), C, a0 + sc.a_m, a_reg);
    load4<T>(dld + static_cast<size_t>(r) * C + b0 + sc.b_n, b_reg);
  };
  const int nk = static_cast<int>((r_end - r_begin + kBK - 1) / kBK);
  float acc[8][8];
  svdd::gemm_tile<svdd::ALayout::MMajor>(sm, nk, load_stage, acc);
  const int tx = tid & 15, ty = tid >> 4;
  float* out = dw_part + static_cast<size_t>(chunk) * C * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* o = out + static_cast<size_t>(a0 + svdd::acc_row(i, ty)) * C + b0;
    store4<float>(o + tx * 4, acc[i]);
    store4<float>(o + 64 + tx * 4, acc[i] + 4);
  }
}

template <typename T, bool HAS_RES>
int launch(const void* x, const void* res, const void* w, const void* wtr,
           const void* ct, void* dx, void* dw, void* scratch_t,
           void* scratch_f, int n, int l, int c, int chunks,
           cudaStream_t stream) {
  const int lh = (l + 1) / 2;
  const long long rows = static_cast<long long>(n) * lh;
  const size_t rlc = static_cast<size_t>(rows) * c;
  T* dld = static_cast<T*>(scratch_t);
  float* wgt = static_cast<float*>(scratch_f);
  float* part = wgt + rlc;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const T* ctp = static_cast<const T*>(ct);
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM), c / kBN);
  pool_bwd_logits_kernel<T, HAS_RES><<<grid, svdd::kGemmThreads, 0, stream>>>(
      xp, rp, static_cast<const T*>(w), ctp, wgt, dld, n, l, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pool_bwd_dgrad_kernel<T><<<grid, svdd::kGemmThreads, 0, stream>>>(
      dld, static_cast<const T*>(wtr), ctp, wgt, static_cast<T*>(dx), n, l, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int rows_per_chunk = static_cast<int>((rows + chunks - 1) / chunks);
  pool_bwd_wgrad_kernel<T, HAS_RES><<<dim3((c / kBM) * (c / kBN), chunks),
                             svdd::kGemmThreads, 0, stream>>>(
      xp, rp, dld, part, n, l, c, rows_per_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return svdd::reduce_partials(part, static_cast<float*>(dw), 1, chunks,
                               static_cast<long long>(c) * c, stream);
}

template <typename T>
int dispatch(const void* x, const void* res, const void* w, const void* wtr,
             const void* ct, void* dx, void* dw, void* scratch_t,
             void* scratch_f, int n, int l, int c, int chunks,
             cudaStream_t stream) {
  if (res)
    return launch<T, true>(x, res, w, wtr, ct, dx, dw, scratch_t, scratch_f,
                           n, l, c, chunks, stream);
  return launch<T, false>(x, res, w, wtr, ct, dx, dw, scratch_t, scratch_f, n,
                          l, c, chunks, stream);
}

}  // namespace

// x, residual (nullable) (N, L, C), w and wtr = w^T (C, C), ct
// (N, ceil(L/2), C), all in the activation type. Outputs: dx (N, L, C)
// in that type (also the residual's gradient), dw (C, C) f32. Scratch:
// scratch_t N*ceil(L/2)*C elements of the type; scratch_f
// N*ceil(L/2)*C + chunks*C*C floats. C a multiple of 128. dtype:
// 0 float32, 1 bfloat16.
extern "C" int svdd_attn_pool_bwd(const void* x, const void* res,
                                  const void* w, const void* wtr,
                                  const void* ct, void* dx, void* dw,
                                  void* scratch_t, void* scratch_f, int n,
                                  int l, int c, int chunks, int dtype,
                                  void* stream) {
  if (n < 1 || l < 1 || c < kBN || c % kBN || chunks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, res, w, wtr, ct, dx, dw, scratch_t, scratch_f, n,
                           l, c, chunks, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, res, w, wtr, ct, dx, dw, scratch_t,
                                   scratch_f, n, l, c, chunks, s);
  return cudaErrorInvalidValue;
}
