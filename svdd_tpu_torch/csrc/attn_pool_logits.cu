// The pairwise attention pool from given logits, alone and fused with the
// next conv block's BN affine, activation and im2col: the pool of an
// attention-pool width off the 128-lane grid, where the module computes
// the logits x @ W with a library product first (JAX's legacy branch,
// svdd_tpu/models/blocks.py:288-298).
//
//   attn_pool_logits (B11a): x, logits (N, L, C), L even ->
//     out[n, i, c] = x1 + (x0 - x1) * sigmoid(l0 - l1), in f32, rounded to
//     x's type, with (x0, x1) = x[n, 2i, c], x[n, 2i+1, c] and likewise l.
//     A pairwise softmax is exactly this blend. Replaces
//     svdd_tpu/ops/attn_pool_pallas.py:attn_pool_pallas (pallas_call :81,
//     body _kernel :46-54).
//   attn_pool_logits_im2col (B11b): that pooled value, rounded to x's type
//     as attn_pool_reference rounds it (:43) before
//     pool_prologue_im2col_reference (:138-149) takes it back to f32, then
//     g = act(pooled * scale + shift) rounded to x's type, written as the
//     k-tap im2col columns over the pooled length (im2col.cuh) ->
//     (N, L/2, k_live*C). Replaces pool_prologue_im2col_pallas (pallas_call
//     :203, body _mega_kernel :152-171), whose body keeps the pooled value
//     in f32: this kernel rounds where the jnp reference rounds.
//
// A pad pair (the caller pads an odd length with a zero row of x and a
// logit of the type's lowest finite value) blends with weight
// sigmoid(l0 - min) = 1: out = 0 + x0 * 1, exactly x0.
//
// What bounds it on an H100: bytes. Both read x and the logits once (2
// N L C elements) and write N L/2 C (B11a) or k_live times that (B11b),
// with a few flops and one exp per output channel. At the off-grid
// Enformer stem pool (N=5120, L=200, C=576, f32) that is 4.7 GB in and
// 1.2 GB (B11a) or 5.9 GB (B11b) out, 1.8 and 3.2 ms at 3.35 TB/s.
// Design: one thread per 4 channels of one pooled row (one channel where
// C % 4 != 0), grid-stride; the TPU kernel's lane-split reshape of the
// pair has no counterpart, since the two rows are read by address. The
// kernels take every N, even L and C.
#include "im2col.cuh"

namespace {

template <typename T, int VEC>
__device__ __forceinline__ void blend(const T* __restrict__ x,
                                      const T* __restrict__ logits, size_t r0,
                                      int C, float* out) {
  float x0[VEC], x1[VEC], l0[VEC], l1[VEC];
  svdd::load_vec<T, VEC>(x + r0, x0);
  svdd::load_vec<T, VEC>(x + r0 + C, x1);
  svdd::load_vec<T, VEC>(logits + r0, l0);
  svdd::load_vec<T, VEC>(logits + r0 + C, l1);
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    out[e] = x1[e] + (x0[e] - x1[e]) * svdd::sigmoid(l0[e] - l1[e]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    attn_pool_logits_kernel(const T* __restrict__ x, const T* __restrict__ logits,
                            T* __restrict__ out, long long rows_out, int C) {
  const int cv = C / VEC;
  const long long total = rows_out * cv;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = idx / cv;       // pooled row n * L/2 + i
    const int c = static_cast<int>(idx - row * cv) * VEC;
    float o[VEC];
    // its pair is input rows 2 row and 2 row + 1
    blend<T, VEC>(x, logits, static_cast<size_t>(2 * row) * C + c, C, o);
    svdd::store_vec<T, VEC>(out + static_cast<size_t>(row) * C + c, o);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    attn_pool_logits_im2col_kernel(const T* __restrict__ x,
                                   const T* __restrict__ logits,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift,
                                   T* __restrict__ out, svdd::Taps taps,
                                   int k_live, int act, long long rows_out,
                                   int LH, int C) {
  const int cv = C / VEC;
  const long long total = rows_out * cv;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = idx / cv;
    const int c = static_cast<int>(idx - row * cv) * VEC;
    const long long n = row / LH;
    const int i = static_cast<int>(row - n * LH);
    float g[VEC];
    blend<T, VEC>(x, logits, static_cast<size_t>(2 * row) * C + c, C, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      g[e] = svdd::round_to<T>(svdd::activate(
          act, __fadd_rn(__fmul_rn(svdd::round_to<T>(g[e]), scale[c + e]),
                         shift[c + e])));
    svdd::scatter_slabs<T, VEC>(out, taps, k_live, n, i, LH, C, c, g);
  }
}

template <typename T>
int launch_pool(const void* x, const void* logits, void* out, int N, int L,
                int C, cudaStream_t stream) {
  const long long rows = static_cast<long long>(N) * (L / 2);
  const T* xt = static_cast<const T*>(x);
  const T* lt = static_cast<const T*>(logits);
  T* o = static_cast<T*>(out);
  if (C % 4 == 0)
    attn_pool_logits_kernel<T, 4><<<svdd::stride_blocks(rows * (C / 4)), 256, 0,
                                    stream>>>(xt, lt, o, rows, C);
  else
    attn_pool_logits_kernel<T, 1><<<svdd::stride_blocks(rows * C), 256, 0, stream>>>(
        xt, lt, o, rows, C);
  return cudaGetLastError();
}

template <typename T>
int launch_im2col(const void* x, const void* logits, const float* scale,
                  const float* shift, void* out, const int* offs, int k_live,
                  int act, int N, int L, int C, cudaStream_t stream) {
  const svdd::Taps taps = svdd::make_taps(offs, k_live);
  const int LH = L / 2;
  const long long rows = static_cast<long long>(N) * LH;
  const T* xt = static_cast<const T*>(x);
  const T* lt = static_cast<const T*>(logits);
  T* o = static_cast<T*>(out);
  if (C % 4 == 0)
    attn_pool_logits_im2col_kernel<T, 4><<<svdd::stride_blocks(rows * (C / 4)), 256,
                                           0, stream>>>(
        xt, lt, scale, shift, o, taps, k_live, act, rows, LH, C);
  else
    attn_pool_logits_im2col_kernel<T, 1><<<svdd::stride_blocks(rows * C), 256, 0,
                                           stream>>>(
        xt, lt, scale, shift, o, taps, k_live, act, rows, LH, C);
  return cudaGetLastError();
}

}  // namespace

// x, logits (N, L, C) contiguous in the activation type, L even, 16-byte
// aligned; out (N, L/2, C). dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_attn_pool_logits(const void* x, const void* logits,
                                     void* out, int N, int L, int C, int dtype,
                                     void* stream) {
  if (N < 1 || L < 2 || L % 2 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pool<float>(x, logits, out, N, L, C, s);
  if (dtype == 1) return launch_pool<__nv_bfloat16>(x, logits, out, N, L, C, s);
  return cudaErrorInvalidValue;
}

// As svdd_attn_pool_logits, then scale, shift (C,) f32, the k_live live
// tap offsets over the pooled length L/2 and an ACT_CODES code; out
// (N, L/2, k_live*C).
extern "C" int svdd_attn_pool_logits_im2col(const void* x, const void* logits,
                                            const float* scale, const float* shift,
                                            void* out, const int* offs, int k_live,
                                            int act, int N, int L, int C,
                                            int dtype, void* stream) {
  if (N < 1 || L < 2 || L % 2 || C < 1 || k_live < 1 || k_live > svdd::kMaxTaps)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_im2col<float>(x, logits, scale, shift, out, offs, k_live, act, N,
                                L, C, s);
  if (dtype == 1)
    return launch_im2col<__nv_bfloat16>(x, logits, scale, shift, out, offs, k_live,
                                        act, N, L, C, s);
  return cudaErrorInvalidValue;
}
