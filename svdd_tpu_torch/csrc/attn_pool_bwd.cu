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
// T() rounds to the activation type; d itself stays f32 in dld, as the
// Pallas body computes it.
//
// Replaces svdd_tpu/ops/attn_pool_pallas.py:attn_pool_wlogits_bwd_pallas
// (pallas_call at :523, body _wl_bwd_kernel :414, formulas :417-423).
//
// What bounds it on an H100: operations, three C x C products over the
// N*ceil(L/2) pairs (the recomputed logits, the dgrad and the wgrad),
// 6*N*LH*C*C flops, on the tensor cores: bf16 mma, or 3xTF32 in f32
// (495/3 TFLOP/s). At the classifier's seven tower pools (N = 512) that
// is 438.6 GFLOP: 2.66 ms on 3xTF32 (6.55 on the f32 FMA pipes), 0.44 ms
// in bf16, against about 2.4 GB (f32) of x, residual, ct, dx and W,
// 0.73 ms at 3.35 TB/s. Design, five launches:
//  1. an elementwise pass writes T(d), (N*LH, C) in the activation type,
//     from the pair rows of x and the residual (the odd tail's missing
//     partner counts as zero): the A operand of the logits product and
//     of the wgrad, built once rather than from four raw rows in every
//     column tile, which holds the forward B3/B4 back (PERF.md §6);
//  2. the logits product T(d) @ W on conv_mma.cuh's tap routine at one
//     tap of offset 0, B operand W^T (stored by rows of output columns).
//     Its epilogue writes wgt (f32) and T(dld) from ct and d in f32: in
//     f32 T(d) is d, read back from pass 1's output; in bf16 T(d) is
//     not, and pass 1 writes d in f32 as well (4 bytes an element in
//     its stream, where re-reading the four raw pair rows here cost the
//     epilogue 8, after the product, not beside it);
//  3. the dgrad T(dld) @ W^T on the same routine, B operand W as stored;
//     its epilogue writes both rows of each pair, dx0 and dx1 = ct - dx0;
//  4. the wgrad T(d)^T @ T(dld), summed over the N*LH rows, on B7's wgrad
//     template (conv_wgrad.cuh) at one tap of offset 0: a block per (row
//     chunk, 128 x 128 tile of dW) with a partial sum a stage in f32 (the
//     tensor cores add by truncation; the first pool sums 51,200 rows);
//  5. the chunks' partials summed by the deterministic pass of reduce.cuh
//     (or the one chunk written as dW) in place of the TPU's
//     sequential-grid accumulator.
#include "conv_mma.cuh"
#include "conv_wgrad.cuh"
#include "reduce.cuh"

namespace {

namespace conv = svdd::conv;

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

// d = s[2p] - s[2p+1] at K consecutive channels of one pair, in f32, s
// = x (+ res) rounded to T; a missing partner counts as zero
template <typename T, int K>
__device__ __forceinline__ void pair_diff(const T* __restrict__ x, const T* __restrict__ res,
                                          const Pair& q, int C, int ch, float* d) {
  float s0[K], s1[K] = {};
  svdd::load_packed<T, K>(x + q.base + ch, s0);
  if (q.pair) svdd::load_packed<T, K>(x + q.base + C + ch, s1);
  if (res) {
    float r[K];
    svdd::load_packed<T, K>(res + q.base + ch, r);
#pragma unroll
    for (int j = 0; j < K; ++j) s0[j] = svdd::round_to<T>(s0[j] + r[j]);
    if (q.pair) {
      svdd::load_packed<T, K>(res + q.base + C + ch, r);
#pragma unroll
      for (int j = 0; j < K; ++j) s1[j] = svdd::round_to<T>(s1[j] + r[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) d[j] = s0[j] - s1[j];
}

// 1. T(d), 16 bytes of it a thread: a block of 8 rows by 32 lanes along
// C. In bf16, where T(d) is not d, d itself too, in f32, into the buffer
// the logits' epilogue then overwrites with wgt (df)
constexpr int kDiffRows = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kDiffRows)
    pool_bwd_diff_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         T* __restrict__ td, float* __restrict__ df, int N, int L,
                         int C) {
  constexpr int kE = 16 / sizeof(T);
  const int lh = (L + 1) / 2;
  const long long row = static_cast<long long>(blockIdx.x) * kDiffRows + threadIdx.y;
  if (row >= static_cast<long long>(N) * lh) return;
  const Pair q = pair_of(row, L, lh, C);
  for (int ch = threadIdx.x * kE; ch < C; ch += 32 * kE) {
    float d[kE];
    pair_diff<T, kE>(x, res, q, C, ch, d);
    svdd::store_packed<T, kE>(td + row * C + ch, d);
    if constexpr (sizeof(T) == 2) {  // kE = 8: two 16-byte stores
      float4* at = reinterpret_cast<float4*>(df + row * C + ch);
      at[0] = make_float4(d[0], d[1], d[2], d[3]);
      at[1] = make_float4(d[4], d[5], d[6], d[7]);
    }
  }
}

// 2. ld = T(d) @ W; wgt and T(dld) written per (pair, channel). d comes
// from T(d) in f32 (they are one) and from pass 1's f32 copy in bf16,
// which wgt then overwrites, each element by the thread that read it
template <typename T>
__global__ void __launch_bounds__(conv::kThreads, conv::Ring1<T>::kBlocks)
    pool_bwd_logits_kernel(const T* __restrict__ td, const T* __restrict__ wtr,
                           const T* __restrict__ ct, float* __restrict__ wgt,
                           T* __restrict__ dld_out, conv::Plan plan, int N, int L,
                           int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lh = (L + 1) / 2;
  const long long rows = static_cast<long long>(N) * lh;
  long long m0;
  int n0;
  conv::tile_origin(C, &m0, &n0);
  float acc[conv::kMT][conv::kNT][4];
  conv::tap_gemm<T, false, conv::Ring1<T>>(td, wtr, plan, rows, 1, C, C, m0, n0,
                                           nullptr, nullptr, 0, smem, acc);
  conv::for_each_pair(acc, m0, n0, rows, [&](long long row, int col, float a, float b) {
    const Pair q = pair_of(row, L, lh, C);
    const size_t at = static_cast<size_t>(row) * C + col;
    float d[2], c[2];
    if constexpr (sizeof(T) == 4)
      svdd::load_packed<T, 2>(td + at, d);
    else
      svdd::load_packed<float, 2>(wgt + at, d);
    svdd::load_packed<T, 2>(ct + at, c);
    const float lg[2] = {a, b};
    float wg[2], dl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      wg[e] = q.tail ? 1.f : svdd::sigmoid(lg[e]);
      dl[e] = q.tail ? 0.f : c[e] * d[e] * wg[e] * (1.f - wg[e]);
    }
    conv::store2(wgt + at, wg[0], wg[1]);
    conv::store2(dld_out + at, dl[0], dl[1]);
  });
}

// 3. dx0 = ct * wgt + T(dld) @ W^T, dx1 = ct - dx0, both rows of a pair
template <typename T>
__global__ void __launch_bounds__(conv::kThreads, conv::Ring1<T>::kBlocks)
    pool_bwd_dgrad_kernel(const T* __restrict__ dld, const T* __restrict__ w,
                          const T* __restrict__ ct, const float* __restrict__ wgt,
                          T* __restrict__ dx, conv::Plan plan, int N, int L, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lh = (L + 1) / 2;
  const long long rows = static_cast<long long>(N) * lh;
  long long m0;
  int n0;
  conv::tile_origin(C, &m0, &n0);
  float acc[conv::kMT][conv::kNT][4];
  conv::tap_gemm<T, false, conv::Ring1<T>>(dld, w, plan, rows, 1, C, C, m0, n0,
                                           nullptr, nullptr, 0, smem, acc);
  conv::for_each_pair(acc, m0, n0, rows, [&](long long row, int col, float a, float b) {
    const Pair q = pair_of(row, L, lh, C);
    const size_t at = static_cast<size_t>(row) * C + col;
    float c[2], wg[2];
    svdd::load_packed<T, 2>(ct + at, c);
    svdd::load_packed<float, 2>(wgt + at, wg);
    const float d0a = c[0] * wg[0] + a, d0b = c[1] * wg[1] + b;
    conv::store2(dx + q.base + col, d0a, d0b);
    if (q.pair) conv::store2(dx + q.base + C + col, c[0] - d0a, c[1] - d0b);
  });
}

// 4. dW partial over pooled rows [chunk * rows_per_chunk, ...): B7's
// wgrad at one tap of offset 0, the rows one sequence
template <typename T>
__global__ void __launch_bounds__(conv::kWThreads, conv::wgrad_blocks<T>())
    pool_bwd_wgrad_kernel(const T* __restrict__ td, const T* __restrict__ dld,
                          float* __restrict__ dw_part, int rows, int C,
                          int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  conv::wgrad_tile<T>(td, dld, dw_part, 0, 1, rows, C, C, rows_per_chunk, smem);
}

template <typename T>
int launch(const void* x, const void* res, const void* w, const void* wtr,
           const void* ct, void* dx, void* dw, void* scratch_t,
           void* scratch_f, int n, int l, int c, int chunks,
           cudaStream_t stream) {
  const int lh = (l + 1) / 2;
  const long long rows = static_cast<long long>(n) * lh;
  if (rows > 0x7fffffffLL || conv::grid_blocks(rows, c) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t rlc = static_cast<size_t>(rows) * c;
  T* td = static_cast<T*>(scratch_t);
  T* dld = td + rlc;
  float* wgt = static_cast<float*>(scratch_f);
  float* part = chunks > 1 ? wgt + rlc : static_cast<float*>(dw);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const T* ctp = static_cast<const T*>(ct);
  const int zero = 0;
  conv::Plan plan;
  conv::make_plan(&zero, 1, conv::Ring1<T>::kGroupTaps, &plan);

  pool_bwd_diff_kernel<T><<<static_cast<unsigned>((rows + kDiffRows - 1) / kDiffRows),
                            dim3(32, kDiffRows), 0, stream>>>(xp, rp, td, wgt, n, l, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr int smem = conv::Ring1<T>::kSmemBytes;
  const unsigned blocks = static_cast<unsigned>(conv::grid_blocks(rows, c));
  if ((e = cudaFuncSetAttribute(pool_bwd_logits_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return e;
  pool_bwd_logits_kernel<T><<<blocks, conv::kThreads, smem, stream>>>(
      td, static_cast<const T*>(wtr), ctp, wgt, dld, plan, n, l, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = cudaFuncSetAttribute(pool_bwd_dgrad_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return e;
  pool_bwd_dgrad_kernel<T><<<blocks, conv::kThreads, smem, stream>>>(
      dld, static_cast<const T*>(w), ctp, wgt, static_cast<T*>(dx), plan, n, l, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t wsmem = conv::wgrad_smem_bytes<T>();
  if ((e = cudaFuncSetAttribute(pool_bwd_wgrad_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(wsmem))) != cudaSuccess)
    return e;
  const int rows_per_chunk = static_cast<int>((rows + chunks - 1) / chunks);
  pool_bwd_wgrad_kernel<T><<<dim3(chunks, (c / conv::kWTile) * (c / conv::kWTile)),
                             conv::kWThreads, wsmem, stream>>>(
      td, dld, part, static_cast<int>(rows), c, rows_per_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (chunks == 1) return cudaSuccess;
  return svdd::reduce_partials(part, static_cast<float*>(dw), 1, chunks,
                               static_cast<long long>(c) * c, stream);
}

}  // namespace

// x, residual (nullable) (N, L, C), w and wtr = w^T (C, C), ct
// (N, ceil(L/2), C), all in the activation type. Outputs: dx (N, L, C)
// in that type (also the residual's gradient), dw (C, C) f32. Scratch:
// scratch_t 2*N*ceil(L/2)*C elements of the type (T(d), T(dld));
// scratch_f N*ceil(L/2)*C floats (wgt), + chunks*C*C (the wgrad's
// partials) where chunks > 1. C a multiple of 128; every tensor 16-byte
// aligned. dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_attn_pool_bwd(const void* x, const void* res,
                                  const void* w, const void* wtr,
                                  const void* ct, void* dx, void* dw,
                                  void* scratch_t, void* scratch_f, int n,
                                  int l, int c, int chunks, int dtype,
                                  void* stream) {
  if (n < 1 || l < 1 || c < conv::kBN || c % conv::kBN || chunks < 1 ||
      (c / conv::kWTile) * (c / conv::kWTile) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, res, w, wtr, ct, dx, dw, scratch_t, scratch_f, n, l,
                         c, chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, res, w, wtr, ct, dx, dw, scratch_t,
                                 scratch_f, n, l, c, chunks, s);
  return cudaErrorInvalidValue;
}
