// The NACDR conv in one kernel: the eval BatchNorm as a per-channel
// affine, the activation and the k-tap SAME conv with its bias,
//   g[n, i, ci]    = act(x[n, i, ci] * scale[ci] + shift[ci])  (f32, then
//                    rounded to x's type),
//   out[n, i, co]  = sum_t sum_ci g[n, i + off_t, ci] W[t, ci, co] + b[co],
// over the live taps t (g is zero outside [0, L): SAME padding pads the
// activated input), the sum and the bias in f32, rounded to x's type
// once. x (N, L, Cin), b (Cout,) in x's type.
//
// Replaces svdd_tpu/ops/fused_conv_pallas.py:fused_conv1d_pallas
// (pallas_call :133, body _kernel :57-77), whose rounding it follows: the
// bias is added to the f32 accumulator and the sum rounded once
// (:76-77). The jnp reference (fused_conv1d_reference :48-54), which the
// plain version ops/fused_conv.py:fused_conv1d_reference copies, rounds
// the conv output to x's type and adds the bias in x's type: the two
// differ by up to one ulp of x's type. The wrapper sends only the shapes
// of JAX's gate here (ops/fused_conv.fused_conv_kernel_takes: Cin and
// Cout multiples of 128).
//
// What bounds it on an H100: operations. 2 Cin Cout per (row, live tap)
// whose source lies inside the sequence; at Basenji's two 128-lane
// residual convs (N=5120, L=25, 256 -> 128 and 128 -> 256, k=5) that is
// 79.9 GFLOP: 0.484 ms on 3xTF32 (f32), 0.081 ms in bf16, against x, W
// and out read or written once (0.117 ms f32, 0.059 bf16 at 3.35 TB/s).
// Design: the tap routine of conv_mma.cuh on the tensor cores (bf16 mma,
// f32 3xTF32), rows (n, i) x columns Cout, summed over (Cin chunk, live
// tap). Each stage's slab of x rows (the tile's rows and the halo) comes
// in by cp.async and one pass in shared memory applies the affine, the
// activation and the rounding once per element (once per column tile
// of Cout); every live tap then reads that slab. A tap's source outside
// its sequence reads the routine's zero row, not act(shift). The B
// operand is W_t^T, stored by rows of Cout: the wrapper transposes the
// live taps.
#include "conv_mma.cuh"

namespace {

namespace conv = svdd::conv;

template <typename T>
__global__ void __launch_bounds__(conv::kThreads, conv::Ring<T>::kBlocks)
    fused_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      const T* __restrict__ bias, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ out,
                      conv::Plan plan, int act, int N, int L, int Cin, int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long NL = static_cast<long long>(N) * L;
  long long m0;
  int n0;
  conv::tile_origin(Cout, &m0, &n0);
  float acc[conv::kMT][conv::kNT][4];
  conv::tap_gemm<T, true>(x, wt, plan, NL, L, Cin, Cout, m0, n0, scale, shift,
                          act, smem, acc);
  conv::store_tile<T>(acc, m0, n0, NL, Cout, out,
                      [=](float a, int col) { return a + svdd::to_f(bias[col]); });
}

template <typename T>
int launch(const void* x, const void* wt, const void* bias, const float* scale,
           const float* shift, void* out, const int* offs, int k_live, int act,
           int N, int L, int Cin, int Cout, cudaStream_t stream) {
  conv::Plan plan;
  if (!conv::make_plan(offs, k_live, conv::Ring<T>::kGroupTaps, &plan))
    return cudaErrorInvalidValue;
  const long long blocks = conv::grid_blocks(static_cast<long long>(N) * L, Cout);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_conv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       conv::Ring<T>::kSmemBytes);
  if (e != cudaSuccess) return e;
  fused_conv_kernel<T><<<static_cast<unsigned>(blocks), conv::kThreads,
                         conv::Ring<T>::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<const T*>(bias),
      scale, shift, static_cast<T*>(out), plan, act, N, L, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

// x (N, L, Cin) and out (N, L, Cout) contiguous in the activation type;
// wt (k_live, Cout, Cin) in that type, the live taps of the (K, Cin,
// Cout) kernel each transposed; bias (Cout,) in that type; scale, shift
// (Cin,) f32; offs the k_live live tap offsets, ascending
// (ops/kernel_utils.live_offsets); act an ACT_CODES code. Cin and Cout
// multiples of 128; x, wt and out 16-byte aligned. dtype: 0 float32,
// 1 bfloat16.
extern "C" int svdd_fused_conv1d(const void* x, const void* wt, const void* bias,
                                 const float* scale, const float* shift,
                                 void* out, const int* offs, int k_live, int act,
                                 int N, int L, int Cin, int Cout, int dtype,
                                 void* stream) {
  if (N < 1 || L < 1 || Cin < conv::kBN || Cin % conv::kBN || Cout < conv::kBN ||
      Cout % conv::kBN)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wt, bias, scale, shift, out, offs, k_live, act, N, L,
                         Cin, Cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wt, bias, scale, shift, out, offs, k_live, act,
                                 N, L, Cin, Cout, s);
  return cudaErrorInvalidValue;
}
