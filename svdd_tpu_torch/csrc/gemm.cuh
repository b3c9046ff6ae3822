// Shared-memory tiled f32 GEMM pieces of the svdd_tpu_torch kernels: one
// block of 256 threads computes a 128 x 128 output tile, C[m][n] =
// sum_k A[m][k] * B[k][n], in 8-deep k stages double-buffered through
// registers, with 8x8 f32 accumulators per thread read as float4 from
// shared memory: the tile of the attention pool (attn_pool.cu, B3/B4).
// The caller supplies how a stage is read from device memory (a lambda
// filling 4 A and 4 B values per thread) and which of two A layouts it
// stores; this header owns the loop, the buffers and the thread-to-output
// map. Used by B8's backward GEMMs, with the deterministic partial-sum
// reduce of reduce.cuh that replaces the TPU's sequential-grid
// accumulators. attn_pool.cu keeps its own copy of the loop: built on
// this header, its pool kernel (f32, with a residual) spilled registers
// and ran about 20% slower on an H100 (scripts/ab_attn_pool.py).
#pragma once

#include "common.cuh"
#include "reduce.cuh"

namespace svdd {

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kGemmThreads = 256;

template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, float* o);
template <>
__device__ __forceinline__ void load4<float>(const float* __restrict__ p,
                                             float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(lo);
  o[1] = __high2float(lo);
  o[2] = __low2float(hi);
  o[3] = __high2float(hi);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float* v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

struct GemmSmem {
  float As[2][kBK][kBM + 4];  // [k][m]; +4 keeps the transposed stores apart
  float Bs[2][kBK][kBN];      // [k][n]
};

// How a thread's 4 A values of a stage are laid out:
//  * KMajor: 4 consecutive k of one row m, m = tid / 2, k = (tid % 2) * 4
//    (A is row-major along k: activations times a weight);
//  * MMajor: 4 consecutive m of one k, k = tid / 32, m = (tid % 32) * 4
//    (A^T is row-major along m: a weight gradient summed over rows).
// The 4 B values are always 4 consecutive n of one k: k = tid / 32,
// n = (tid % 32) * 4.
enum class ALayout { KMajor, MMajor };

struct StageCoords {
  int a_m, a_k;  // first A element this thread loads
  int b_k, b_n;  // first B element this thread loads
};

template <ALayout AL>
__device__ __forceinline__ StageCoords stage_coords(int tid) {
  StageCoords s;
  if (AL == ALayout::KMajor) {
    s.a_m = tid >> 1;
    s.a_k = (tid & 1) * 4;
  } else {
    s.a_k = tid >> 5;
    s.a_m = (tid & 31) * 4;
  }
  s.b_k = tid >> 5;
  s.b_n = (tid & 31) * 4;
  return s;
}

// The output row of accumulator row i (0..7), relative to the tile
// origin; accumulator columns 0..3 are tx*4 + 0..3, columns 4..7 are
// 64 + tx*4 + 0..3.
__device__ __forceinline__ int acc_row(int i, int ty) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
}

// acc = sum over nk stages of A_stage @ B_stage. load(s, a, b) reads
// stage s (k = s*kBK .. s*kBK+7) into this thread's registers at the
// coordinates of stage_coords<AL>, zeros where the operand is out of
// range.
template <ALayout AL, typename Load>
__device__ __forceinline__ void gemm_tile(GemmSmem& sm, int nk, Load load,
                                          float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const StageCoords sc = stage_coords<AL>(tid);
  float a_reg[4], b_reg[4];
  auto store = [&](int buf) {
    if (AL == ALayout::KMajor) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sm.As[buf][sc.a_k + e][sc.a_m] = a_reg[e];
    } else {
      *reinterpret_cast<float4*>(&sm.As[buf][sc.a_k][sc.a_m]) =
          make_float4(a_reg[0], a_reg[1], a_reg[2], a_reg[3]);
    }
    *reinterpret_cast<float4*>(&sm.Bs[buf][sc.b_k][sc.b_n]) =
        make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (nk <= 0) return;
  load(0, a_reg, b_reg);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1, a_reg, b_reg);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(&sm.As[cur][kk][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&sm.As[cur][kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(&sm.Bs[cur][kk][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&sm.Bs[cur][kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

}  // namespace svdd
