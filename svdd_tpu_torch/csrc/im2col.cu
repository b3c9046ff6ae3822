// The NACDR prologue and im2col of a k-tap conv: the eval BatchNorm as a
// per-channel affine, the activation, then the columns of the live taps,
//   g[n, i, c]          = act(x[n, i, c] * scale[c] + shift[c])  (f32, then
//                         rounded to x's type),
//   out[n, i, j*C + c]  = g[n, i + off_j, c], zero outside [0, L),
// x (N, L, C) -> out (N, L, k_live*C). The conv itself is then one matrix
// product against the stacked live-tap weight, outside the kernel
// (ops/im2col.py:nacdr_conv1d), as the JAX package leaves it to XLA.
//
// Replaces svdd_tpu/ops/im2col_pallas.py:nacdr_im2col_pallas (pallas_call
// :100, body _kernel :53-66); rounding as nacdr_im2col_reference (:41):
// the affine (a product and a sum, not fused) and the activation in f32,
// g rounded to x's type once.
//
// What bounds it on an H100: bytes. x is read once and k_live times as
// many bytes are written; a handful of flops (one erfc for the exact gelu)
// per element read. At Basenji's residual blocks (N=5120, L=25, C=324,
// k=5, f32) that is 166 MB in and 829 MB out, about 0.30 ms at 3.35 TB/s.
// Design: one thread per 4 channels of one input row (one channel where
// C % 4 != 0), grid-stride; it activates its values once and writes them
// into every slab that reads them, plus the zeros of its own row's slabs
// that read outside the sequence (im2col.cuh), so every output element is
// written once and neighbouring threads write neighbouring addresses. The
// TPU kernel's tile-size search (VMEM budget) has no counterpart: nothing
// is staged on chip. The kernel takes every N, L and C.
#include "im2col.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    nacdr_im2col_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ shift, T* __restrict__ out,
                        svdd::Taps taps, int k_live, int act, long long rows,
                        int L, int C) {
  const int cv = C / VEC;
  const long long total = rows * cv;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = idx / cv;
    const int c = static_cast<int>(idx - row * cv) * VEC;
    const long long n = row / L;
    const int i = static_cast<int>(row - n * L);
    float g[VEC];
    svdd::load_vec<T, VEC>(x + static_cast<size_t>(row) * C + c, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      g[e] = svdd::round_to<T>(svdd::activate(
          act, __fadd_rn(__fmul_rn(g[e], scale[c + e]), shift[c + e])));
    svdd::scatter_slabs<T, VEC>(out, taps, k_live, n, i, L, C, c, g);
  }
}

template <typename T>
int launch(const void* x, const float* scale, const float* shift, void* out,
           const int* offs, int k_live, int act, int N, int L, int C,
           cudaStream_t stream) {
  const svdd::Taps taps = svdd::make_taps(offs, k_live);
  const long long rows = static_cast<long long>(N) * L;
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (C % 4 == 0) {
    nacdr_im2col_kernel<T, 4><<<svdd::stride_blocks(rows * (C / 4)), 256, 0, stream>>>(
        xt, scale, shift, o, taps, k_live, act, rows, L, C);
  } else {
    nacdr_im2col_kernel<T, 1><<<svdd::stride_blocks(rows * C), 256, 0, stream>>>(
        xt, scale, shift, o, taps, k_live, act, rows, L, C);
  }
  return cudaGetLastError();
}

}  // namespace

// x (N, L, C) and out (N, L, k_live*C) contiguous in the activation type,
// 16-byte aligned; scale, shift (C,) f32; offs the k_live live tap
// offsets (ops/kernel_utils.live_offsets); act an ACT_CODES code.
// dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_nacdr_im2col(const void* x, const float* scale,
                                 const float* shift, void* out, const int* offs,
                                 int k_live, int act, int N, int L, int C,
                                 int dtype, void* stream) {
  if (N < 1 || L < 1 || C < 1 || k_live < 1 || k_live > svdd::kMaxTaps)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, shift, out, offs, k_live, act, N, L, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, shift, out, offs, k_live, act, N, L, C, s);
  return cudaErrorInvalidValue;
}
