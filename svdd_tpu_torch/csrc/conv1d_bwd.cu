// Backward of the SAME-padded 1-D convolution y = conv1d_shifted(x, W, d)
// (y[j] = sum over live taps t of x[j + off_t] @ W_t): given the output
// cotangent ct,
//   dx[j]  = sum_t ct[j - off_t] @ W_t^T      (dgrad)
//   dW_t   = x^T @ shift(ct, -off_t)          (wgrad, summed over rows)
// Dead taps (|off| >= L) get no gradient here; the wrapper leaves their
// rows of dW at zero.
//
// Replaces svdd_tpu/ops/conv1d_bwd_pallas.py:conv1d_bwd_pallas
// (pallas_call at :141, body _bwd_kernel :52). The conv forward stays a
// library convolution in both packages (conv1d_bwd_pallas.py:27-31).
//
// What bounds it on an H100: 2 * 2*N*L*k_live*Cin*Cout flops (dgrad and
// wgrad), on the f32 FMA pipes in this version; at the value tower's
// first k=5 conv, (512, 100, 768 -> 768), that is 604 GFLOP, about
// 9.0 ms at the 67 TFLOP/s published f32 peak, against 0.49 GB of x,
// ct, dx and W (0.15 ms at 3.35 TB/s). Design: two 128x128-tile GEMMs of
// gemm.cuh.
//  * dgrad: rows (n, j) x columns Cin, summed over (tap, Cout): each
//    stage reads 8 channels of ct at row j - off_t straight from device
//    memory (zero outside the sequence), so the shifted im2col of ct is
//    never built; the B operand is W_t^T, stacked by the wrapper.
//  * wgrad: per (tap, 128x128 tile of W, chunk of rows) the product of
//    x rows shifted by off_t and ct rows; chunk partials are summed by
//    a deterministic second pass (gemm.cuh reduce) instead of the TPU's
//    sequential-grid accumulator.
// x and ct are read once by each GEMM.
#include "gemm.cuh"

namespace {

using svdd::kBK;
using svdd::kBM;
using svdd::kBN;

template <typename T>
__global__ void __launch_bounds__(svdd::kGemmThreads, 2)
    conv_bwd_dgrad_kernel(const T* __restrict__ ct, const T* __restrict__ wt,
                          T* __restrict__ dx, svdd::Taps taps, int k_live,
                          int N, int L, int Cin, int Cout) {
  __shared__ __align__(16) svdd::GemmSmem sm;
  const long long rows = static_cast<long long>(N) * L;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const svdd::StageCoords sc = svdd::stage_coords<svdd::ALayout::KMajor>(tid);
  const long long a_row = m0 + sc.a_m;
  const bool a_valid = a_row < rows;
  const long long a_n = a_valid ? a_row / L : 0;
  const int a_j = a_valid ? static_cast<int>(a_row - a_n * L) : 0;
  const int stages_per_tap = Cout / kBK;
  auto load_stage = [&](int s, float* a_reg, float* b_reg) {
    const int t = s / stages_per_tap;
    const int b0 = (s - t * stages_per_tap) * kBK;
    const int src = a_j - taps.off[t];
#pragma unroll
    for (int e = 0; e < 4; ++e) a_reg[e] = 0.f;
    if (a_valid && src >= 0 && src < L)
      svdd::load4<T>(ct + (static_cast<size_t>(a_n) * L + src) * Cout + b0 + sc.a_k,
                     a_reg);
    svdd::load4<T>(wt + (static_cast<size_t>(t) * Cout + b0 + sc.b_k) * Cin +
                       n0 + sc.b_n,
                   b_reg);
  };
  float acc[8][8];
  svdd::gemm_tile<svdd::ALayout::KMajor>(sm, k_live * stages_per_tap,
                                         load_stage, acc);
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + svdd::acc_row(i, ty);
    if (row >= rows) continue;
    T* o = dx + static_cast<size_t>(row) * Cin + n0;
    svdd::store4<T>(o + tx * 4, acc[i]);
    svdd::store4<T>(o + 64 + tx * 4, acc[i] + 4);
  }
}

// dW_t[a0.., b0..] partial over rows [chunk * rows_per_chunk, ...)
template <typename T>
__global__ void __launch_bounds__(svdd::kGemmThreads, 2)
    conv_bwd_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                          float* __restrict__ dw_part, svdd::Taps taps, int N,
                          int L, int Cin, int Cout, int rows_per_chunk) {
  __shared__ __align__(16) svdd::GemmSmem sm;
  const int tiles_b = Cout / kBN;
  const int a0 = (blockIdx.x / tiles_b) * kBM;
  const int b0 = (blockIdx.x % tiles_b) * kBN;
  const int chunk = blockIdx.y, chunks = gridDim.y, t = blockIdx.z;
  const int off = taps.off[t];
  const long long total = static_cast<long long>(N) * L;
  const long long r_begin = static_cast<long long>(chunk) * rows_per_chunk;
  const long long r_end = min(total, r_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const svdd::StageCoords sc = svdd::stage_coords<svdd::ALayout::MMajor>(tid);
  auto load_stage = [&](int s, float* a_reg, float* b_reg) {
    const long long r = r_begin + static_cast<long long>(s) * kBK + sc.a_k;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_reg[e] = b_reg[e] = 0.f;
    if (r >= r_end) return;
    const long long n = r / L;
    const int i = static_cast<int>(r - n * L);
    const int src = i + off;
    if (src >= 0 && src < L)
      svdd::load4<T>(x + (static_cast<size_t>(n) * L + src) * Cin + a0 + sc.a_m,
                     a_reg);
    svdd::load4<T>(ct + static_cast<size_t>(r) * Cout + b0 + sc.b_n, b_reg);
  };
  const int nk = static_cast<int>((r_end - r_begin + kBK - 1) / kBK);
  float acc[8][8];
  svdd::gemm_tile<svdd::ALayout::MMajor>(sm, nk, load_stage, acc);
  const int tx = tid & 15, ty = tid >> 4;
  float* out = dw_part + (static_cast<size_t>(t) * chunks + chunk) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* o = out + static_cast<size_t>(a0 + svdd::acc_row(i, ty)) * Cout + b0;
    svdd::store4<float>(o + tx * 4, acc[i]);
    svdd::store4<float>(o + 64 + tx * 4, acc[i] + 4);
  }
}

template <typename T>
int launch(const void* x, const void* wt, const void* ct, void* dx, void* dw,
           void* scratch_f, const int* offsets, int k_live, int n, int l,
           int cin, int cout, int chunks, cudaStream_t stream) {
  const svdd::Taps taps = svdd::make_taps(offsets, k_live);
  const long long rows = static_cast<long long>(n) * l;
  conv_bwd_dgrad_kernel<T><<<dim3(static_cast<unsigned>((rows + kBM - 1) / kBM),
                         cin / kBN),
                    svdd::kGemmThreads, 0, stream>>>(
      static_cast<const T*>(ct), static_cast<const T*>(wt),
      static_cast<T*>(dx), taps, k_live, n, l, cin, cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows_per_chunk = static_cast<int>((rows + chunks - 1) / chunks);
  float* part = static_cast<float*>(scratch_f);
  conv_bwd_wgrad_kernel<T><<<dim3((cin / kBM) * (cout / kBN), chunks, k_live),
                    svdd::kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ct), part, taps, n, l,
      cin, cout, rows_per_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return svdd::reduce_partials(part, static_cast<float*>(dw), k_live, chunks,
                               static_cast<long long>(cin) * cout, stream);
}

}  // namespace

// x (N, L, Cin), ct (N, L, Cout) in the activation type; wt (k_live,
// Cout, Cin) in that type, the live taps' W_t^T; offsets (k_live,) host
// ints, ascending. Outputs: dx (N, L, Cin) in the activation type, dw
// (k_live, Cin, Cout) f32. scratch_f: chunks*k_live*Cin*Cout floats.
// Cin and Cout multiples of 128. dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_conv1d_bwd(const void* x, const void* wt, const void* ct,
                               void* dx, void* dw, void* scratch_f,
                               const void* offsets, int k_live, int n, int l,
                               int cin, int cout, int chunks, int dtype,
                               void* stream) {
  if (n < 1 || l < 1 || cin < kBM || cin % kBM || cout < kBN || cout % kBN ||
      k_live < 1 || k_live > svdd::kMaxTaps || chunks < 1)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wt, ct, dx, dw, scratch_f, offs, k_live, n, l,
                         cin, cout, chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wt, ct, dx, dw, scratch_f, offs, k_live,
                                 n, l, cin, cout, chunks, s);
  return cudaErrorInvalidValue;
}
