// The NACDR conv in one kernel: the eval BatchNorm as a per-channel
// affine, the activation and the k-tap SAME conv with its bias,
//   g[n, i, ci]    = act(x[n, i, ci] * scale[ci] + shift[ci])  (f32, then
//                    rounded to x's type),
//   out[n, i, co]  = sum_t sum_ci g[n, i + off_t, ci] W[t, ci, co] + b[co],
// over the live taps t (zero outside [0, L)), the sum and the bias in f32,
// rounded to x's type once. x (N, L, Cin), W (k_live, Cin, Cout) the live
// taps of the (K, Cin, Cout) kernel in x's type, b (Cout,) in x's type.
//
// Replaces svdd_tpu/ops/fused_conv_pallas.py:fused_conv1d_pallas
// (pallas_call :133, body _kernel :57-77), whose rounding it follows: the
// bias is added to the f32 accumulator and the sum rounded once
// (:76-77). The jnp reference (fused_conv1d_reference :48-54), which the
// plain version ops/fused_conv.py:fused_conv1d_reference copies, rounds
// the conv output to x's type and adds the bias in x's type: the two
// differ by up to one ulp of x's type.
//
// What bounds it on an H100: operations. 2 N L k_live Cin Cout flops
// against x, W and out read or written once; at Basenji's 128-lane
// residual convs (N=5120, L=25, 256 -> 128, k=5, f32) that is 41.9 GFLOP,
// 0.63 ms at the 67 TFLOP/s f32 peak, against 0.20 GB, 0.059 ms at
// 3.35 TB/s. Design: an implicit-im2col GEMM on the 128 x 128 f32 tile of
// gemm.cuh, rows (n, i) x columns Cout, summed over (tap, Cin) in stages
// of 8 channels: each stage reads its A values straight from x at row
// i + off_t and applies the affine and the activation as it loads them
// (zero outside the sequence), so neither the activated input nor the
// im2col columns reach device memory; the TPU kernel's K dots over a
// zero-padded VMEM copy become this one loop. The products run on the
// FMA pipes (the values of either type are exact in f32). Every N, L,
// Cin and Cout is taken: loads and stores are masked at the edges.
#include "gemm.cuh"

namespace {

using svdd::kBK;
using svdd::kBM;
using svdd::kBN;

template <typename T>
__global__ void __launch_bounds__(svdd::kGemmThreads, 2)
    fused_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ out,
                      svdd::Taps taps, int k_live, int act, int N, int L, int Cin,
                      int Cout) {
  __shared__ __align__(16) svdd::GemmSmem sm;
  const long long rows = static_cast<long long>(N) * L;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const svdd::StageCoords sc = svdd::stage_coords<svdd::ALayout::KMajor>(tid);
  const long long a_row = m0 + sc.a_m;
  const bool a_valid = a_row < rows;
  const long long a_n = a_valid ? a_row / L : 0;
  const int a_i = a_valid ? static_cast<int>(a_row - a_n * L) : 0;
  const int stages_per_tap = (Cin + kBK - 1) / kBK;
  auto load_stage = [&](int s, float* a_reg, float* b_reg) {
    const int t = s / stages_per_tap;
    const int c0 = (s - t * stages_per_tap) * kBK;
    const int src = a_i + taps.off[t];
    const bool in_seq = a_valid && src >= 0 && src < L;
    const T* xr = in_seq ? x + (static_cast<size_t>(a_n) * L + src) * Cin : x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = c0 + sc.a_k + e;
      a_reg[e] = in_seq && ci < Cin
                     ? svdd::round_to<T>(svdd::activate(
                           act, __fadd_rn(__fmul_rn(svdd::to_f(xr[ci]), scale[ci]),
                                          shift[ci])))
                     : 0.f;
    }
    const int ci = c0 + sc.b_k;
    const T* wr = w + (static_cast<size_t>(t) * Cin + ci) * Cout;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = n0 + sc.b_n + e;
      b_reg[e] = ci < Cin && co < Cout ? svdd::to_f(wr[co]) : 0.f;
    }
  };
  float acc[8][8];
  svdd::gemm_tile<svdd::ALayout::KMajor>(sm, k_live * stages_per_tap, load_stage,
                                         acc);
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + svdd::acc_row(i, ty);
    if (row >= rows) continue;
    T* o = out + static_cast<size_t>(row) * Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = n0 + h * 64 + tx * 4 + e;
        if (co < Cout) o[co] = svdd::from_f<T>(acc[i][h * 4 + e] + svdd::to_f(bias[co]));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const float* scale,
           const float* shift, void* out, const int* offs, int k_live, int act,
           int N, int L, int Cin, int Cout, cudaStream_t stream) {
  const svdd::Taps taps = svdd::make_taps(offs, k_live);
  const long long rows = static_cast<long long>(N) * L;
  const long long row_tiles = (rows + kBM - 1) / kBM;
  if (row_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(row_tiles), (Cout + kBN - 1) / kBN);
  fused_conv_kernel<T><<<grid, svdd::kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      scale, shift, static_cast<T*>(out), taps, k_live, act, N, L, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

// x (N, L, Cin), w (k_live, Cin, Cout), bias (Cout,) and out (N, L, Cout)
// contiguous in the activation type; scale, shift (Cin,) f32; offs the
// k_live live tap offsets (ops/kernel_utils.live_offsets); act an
// ACT_CODES code. dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_fused_conv1d(const void* x, const void* w, const void* bias,
                                 const float* scale, const float* shift,
                                 void* out, const int* offs, int k_live, int act,
                                 int N, int L, int Cin, int Cout, int dtype,
                                 void* stream) {
  if (N < 1 || L < 1 || Cin < 1 || Cout < 1 || k_live < 1 ||
      k_live > svdd::kMaxTaps || (Cout + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, bias, scale, shift, out, offs, k_live, act, N, L,
                         Cin, Cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, scale, shift, out, offs, k_live, act,
                                 N, L, Cin, Cout, s);
  return cudaErrorInvalidValue;
}
