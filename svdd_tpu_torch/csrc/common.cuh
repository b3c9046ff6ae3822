// Shared device helpers for the svdd_tpu_torch kernels. Each .cu file
// that includes this header is built into its own shared library with
// a plain C interface (svdd_tpu_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace svdd {

constexpr int kMaxTaps = 16;

// Tap offsets passed by value as a kernel argument.
struct Taps {
  int off[kMaxTaps];
};

inline Taps make_taps(const int* offs, int n) {
  Taps t{};
  for (int i = 0; i < n && i < kMaxTaps; ++i) t.off[i] = offs[i];
  return t;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to the storage type T and read back as float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// act codes: 0 none, 1 gelu_enformer, 2 relu, 3 the exact gelu as
// jax.nn.gelu(approximate=False) writes it, 0.5 v erfc(-v / sqrt 2)
// (ops/kernel_utils.ACT_CODES)
__device__ __forceinline__ float activate(int act, float v) {
  if (act == 1) return v * sigmoid(1.702f * v);
  if (act == 2) return fmaxf(v, 0.f);
  if (act == 3) return 0.5f * v * erfcf(-v * 0.70710678118654752f);
  return v;
}

}  // namespace svdd

extern "C" const char* svdd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
