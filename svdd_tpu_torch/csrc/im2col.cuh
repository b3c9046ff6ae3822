// The im2col slab writer shared by the NACDR prologue kernels that emit a
// k-tap conv's columns: nacdr_im2col (im2col.cu, B11c) and the pool
// variant attn_pool_logits_im2col (attn_pool_logits.cu, B11b).
//
// Per sequence, out is (L, k_live, C): out[i, j, c] = g[i + off_j, c],
// zero where i + off_j lies outside [0, L), with off_j the live tap
// offsets of ops/kernel_utils.live_offsets in order, so the column order
// matches the stacked weight kernel[live taps] that consumes it. A thread
// that holds g[i, c .. c+VEC) (already rounded to the storage type) writes
// it to every output row that reads it, i - off_j, and writes the zeros of
// its own row i whose slab j reads outside the sequence: each output
// element is written exactly once, and neighbouring threads (neighbouring
// c) write neighbouring addresses.
#pragma once

#include "common.cuh"

namespace svdd {

// VEC values of T at p, as floats: VEC 4 is one 16-byte (f32) or 8-byte
// (bf16) access and needs that alignment; VEC 1 any address.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* o) {
  if constexpr (VEC == 4) {
    load_packed<T, 4>(p, o);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = to_f(p[e]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC == 4) {
    store_packed<T, 4>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = from_f<T>(v[e]);
  }
}

// g: the VEC activated values of row i (sequence n), channels c ..
template <typename T, int VEC>
__device__ __forceinline__ void scatter_slabs(T* __restrict__ out,
                                              const Taps& taps, int k_live,
                                              long long n, int i, int L,
                                              int C, int c, const float* g) {
  float zero[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) zero[e] = 0.f;
  const size_t seq = static_cast<size_t>(n) * L;
  for (int j = 0; j < k_live; ++j) {
    const int o = i - taps.off[j];
    if (o >= 0 && o < L)
      store_vec<T, VEC>(out + ((seq + o) * k_live + j) * C + c, g);
    const int src = i + taps.off[j];
    if (src < 0 || src >= L)
      store_vec<T, VEC>(out + ((seq + i) * k_live + j) * C + c, zero);
  }
}

// a grid-stride launch of `total` work items, 256 threads a block, at
// most 16 blocks an SM
inline unsigned stride_blocks(long long total) {
  const long long blocks = (total + 255) / 256, most = 16LL * sm_count();
  return static_cast<unsigned>(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

}  // namespace svdd
