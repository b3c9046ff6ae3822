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
// What bounds it on an H100: operations, 2 * 2*C_in*C_out per (row, live
// tap) whose source lies inside the sequence (dgrad and wgrad), on the
// tensor cores: bf16 mma, or 3xTF32 in f32 (495/3 TFLOP/s). At the value
// tower's six k=5 convs at N=512 that is 1450.7 GFLOP: 8.79 ms on
// 3xTF32, 1.47 ms in bf16, against 1.31 GB (f32) of x, ct, dx, W and dW,
// 0.39 ms at 3.35 TB/s. Design,
// two tensor-core GEMMs and, where the rows are split, a reduce:
//  * dgrad: the tap routine of conv_mma.cuh, rows (n, j) x columns Cin,
//    summed over (Cout chunk, live tap): the mirrored tap sum
//    dx[j] = sum_u ct[j + off'_u] . W_{k-1-u}^T with off'_u = -off_{k-1-u}
//    (ascending), whose B operand, stored by rows of Cin, is W_{k-1-u}
//    itself: the wrapper passes the live taps in reverse order. Each ct
//    row of a tile and its halo is loaded once per Cout chunk and read by
//    every tap;
//  * wgrad: per (row chunk, 128 x 128 tile of dW_t, tap) the GEMM
//    dW_t[ci][co] = sum over rows r of x[r + off_t][ci] ct[r][co] of
//    conv_wgrad.cuh (shared with B8's wgrad), rows streamed through a
//    cp.async ring; the chunks' partials are summed by a deterministic
//    second pass (reduce.cuh), or written as dW where there is one
//    chunk. The chunks (ops/conv1d.py, _build.row_chunks) fill the card
//    twice over; the smallest tower conv (2048 rows, 1280 -> 1536) is
//    600 blocks.
#include "conv_wgrad.cuh"
#include "reduce.cuh"

namespace {

namespace conv = svdd::conv;
namespace mma = svdd::mma;

template <typename T>
__global__ void __launch_bounds__(conv::kThreads, conv::Ring<T>::kBlocks)
    conv_bwd_dgrad_kernel(const T* __restrict__ ct, const T* __restrict__ wflip,
                          T* __restrict__ dx, conv::Plan plan, int N, int L,
                          int Cin, int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long NL = static_cast<long long>(N) * L;
  long long m0;
  int n0;
  conv::tile_origin(Cin, &m0, &n0);
  float acc[conv::kMT][conv::kNT][4];
  conv::tap_gemm<T, false>(ct, wflip, plan, NL, L, Cout, Cin, m0, n0, nullptr,
                           nullptr, 0, smem, acc);
  conv::store_tile<T>(acc, m0, n0, NL, Cin, dx, [](float a, int) { return a; });
}

// B7's wgrad: one block per (row chunk, tile of dW_t, live tap), the
// tap's offset from taps
template <typename T>
__global__ void __launch_bounds__(conv::kWThreads, conv::wgrad_blocks<T>())
    conv_bwd_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                          float* __restrict__ dw_part, svdd::Taps taps, int N,
                          int L, int Cin, int Cout, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  conv::wgrad_tile<T>(x, ct, dw_part, taps.off[blockIdx.z], N, L, Cin, Cout,
                      rows_per_chunk, smem);
}

template <typename T>
int launch(const void* x, const void* wflip, const void* ct, void* dx, void* dw,
           void* scratch_f, const int* offsets, int k_live, int n, int l,
           int cin, int cout, int chunks, cudaStream_t stream) {
  // the dgrad's mirrored taps: offsets -off_{k-1-u}, ascending
  int mirrored[svdd::kMaxTaps];
  for (int u = 0; u < k_live; ++u) mirrored[u] = -offsets[k_live - 1 - u];
  conv::Plan plan;
  if (!conv::make_plan(mirrored, k_live, conv::Ring<T>::kGroupTaps, &plan))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(n) * l;
  const long long blocks = conv::grid_blocks(rows, cin);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv_bwd_dgrad_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       conv::Ring<T>::kSmemBytes);
  if (e != cudaSuccess) return e;
  conv_bwd_dgrad_kernel<T><<<static_cast<unsigned>(blocks), conv::kThreads,
                             conv::Ring<T>::kSmemBytes, stream>>>(
      static_cast<const T*>(ct), static_cast<const T*>(wflip), static_cast<T*>(dx),
      plan, n, l, cin, cout);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t wsmem = conv::wgrad_smem_bytes<T>();
  e = cudaFuncSetAttribute(conv_bwd_wgrad_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(wsmem));
  if (e != cudaSuccess) return e;
  const int rows_per_chunk = static_cast<int>((rows + chunks - 1) / chunks);
  float* part = chunks > 1 ? static_cast<float*>(scratch_f) : static_cast<float*>(dw);
  const svdd::Taps taps = svdd::make_taps(offsets, k_live);
  conv_bwd_wgrad_kernel<T><<<dim3(chunks, (cin / conv::kWTile) * (cout / conv::kWTile), k_live),
                             conv::kWThreads, wsmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ct), part, taps, n, l, cin,
      cout, rows_per_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (chunks == 1) return cudaSuccess;
  return svdd::reduce_partials(part, static_cast<float*>(dw), k_live, chunks,
                               static_cast<long long>(cin) * cout, stream);
}

}  // namespace

// x (N, L, Cin), ct (N, L, Cout) in the activation type; wflip (k_live,
// Cin, Cout) in that type, the live taps of the (K, Cin, Cout) kernel in
// reverse order; offsets (k_live,) host ints, the live taps' offsets,
// ascending. Outputs: dx (N, L, Cin) in the activation type, dw (k_live,
// Cin, Cout) f32 in the forward's tap order. scratch_f:
// chunks*k_live*Cin*Cout floats (unused when chunks is 1). Cin and Cout
// multiples of 128; every tensor 16-byte aligned. dtype: 0 float32,
// 1 bfloat16.
extern "C" int svdd_conv1d_bwd(const void* x, const void* wflip, const void* ct,
                               void* dx, void* dw, void* scratch_f,
                               const void* offsets, int k_live, int n, int l,
                               int cin, int cout, int chunks, int dtype,
                               void* stream) {
  if (n < 1 || l < 1 || cin < conv::kBN || cin % conv::kBN || cout < conv::kBN ||
      cout % conv::kBN || k_live < 1 || k_live > svdd::kMaxTaps || chunks < 1 ||
      (cin / conv::kWTile) * (cout / conv::kWTile) > 65535)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wflip, ct, dx, dw, scratch_f, offs, k_live, n, l,
                         cin, cout, chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wflip, ct, dx, dw, scratch_f, offs, k_live,
                                 n, l, cin, cout, chunks, s);
  return cudaErrorInvalidValue;
}
