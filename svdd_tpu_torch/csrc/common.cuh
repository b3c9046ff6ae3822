// Shared device helpers for the svdd_tpu_torch kernels. Each .cu file
// that includes this header is built into its own shared library with
// a plain C interface (svdd_tpu_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// K consecutive elements of T at p (K * sizeof(T) of 2 (one bf16), 4,
// 8 or 16 bytes, aligned to that) as floats, in one load; and back,
// rounded to T. bf16 goes by pairs in 32-bit words, so the values stay
// in registers.
template <int Bytes>
using Packed = typename std::conditional<
    Bytes == 16, uint4, typename std::conditional<Bytes == 8, uint2, uint32_t>::type>::type;

template <typename T, int K>
__device__ __forceinline__ void load_packed(const T* __restrict__ p, float* v) {
  if constexpr (K * sizeof(T) == 2) {
    v[0] = to_f(*p);
  } else {
    using V = Packed<K * sizeof(T)>;
    const V u = *reinterpret_cast<const V*>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
    for (int j = 0; j < static_cast<int>(sizeof(V) / 4); ++j) {
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(w + j);
        v[2 * j] = __low2float(h);
        v[2 * j + 1] = __high2float(h);
      } else {
        v[j] = __uint_as_float(w[j]);
      }
    }
  }
}

template <typename T, int K>
__device__ __forceinline__ void store_packed(T* __restrict__ p, const float* v) {
  if constexpr (K * sizeof(T) == 2) {
    *p = from_f<T>(v[0]);
  } else {
    using V = Packed<K * sizeof(T)>;
    V u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int j = 0; j < static_cast<int>(sizeof(V) / 4); ++j) {
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        w[j] = __float_as_uint(v[j]);
      }
    }
    *reinterpret_cast<V*>(p) = u;
  }
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

// The card's streaming multiprocessors (132 on an H100 SXM), read once
// a process from the current device: the port drives one card, or
// cards of one kind. Sizes grids and picks between kernels.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 1;
    return v > 0 ? v : 1;
  }();
  return n;
}

}  // namespace svdd

extern "C" const char* svdd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
