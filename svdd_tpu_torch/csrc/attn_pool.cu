// Pairwise attention pool of the Enformer value tower, alone (B4) or
// fused with the next conv block's BN affine, activation and im2col
// (B3, compile-time flag IM2COL).
//
// Replaces svdd_tpu/ops/attn_pool_pallas.py:
//   attn_pool_wlogits_lnc_pallas            (pallas_call :916, body :867)
//   pool_prologue_im2col_wlogits_lnc_pallas (pallas_call :1071, body :1008)
//
// Per pair p of rows of s = x (+ residual, added in x's type):
//   d = s[2p] - s[2p+1] (f32), ld = T(d) @ W (f32 sums),
//   pooled = s[2p+1] + d * sigmoid(ld)
// and when L is odd the last pair is (s[L-1], 0) with its weight forced
// to 1, so it pools to s[L-1]. B3 then writes y = act(pooled * scale +
// shift) into the k_live im2col slabs of the next conv:
//   cols[n, q, j*C + c] = y[n, q + off_j, c], zero outside [0, LH).
//
// What bounds it on an H100: the C x C product, N*LH*C*C*2 flops
// (0.29 GFLOP per candidate over the 7 pools of the full tower, 1.5
// TFLOP per guided step at B*M = 5120), on the f32 FMA pipes in this
// version; device-memory traffic is x (+ residual) in and the pooled
// rows or the im2col slabs out. Design: a shared-memory tiled GEMM over
// rows = (candidate, pair), 128 x 128 output tiles, 8-deep k stages
// double-buffered through registers, 8x8 f32 accumulators per thread
// read as float4 from shared memory. The prologue (residual add, pair
// difference, cast) runs while the next stage is loaded, so d never
// reaches device memory; the epilogue re-reads the pair (L2-resident)
// for the f32 blend and scatters, so the pooled tensor never does
// either on the B3 path.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kThreads = 256;

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

// s = x (+ res) at 4 consecutive channels, rounded to T like the
// reference's add in the activation type
template <typename T, bool HAS_RES>
__device__ __forceinline__ void load_s4(const T* __restrict__ x,
                                        const T* __restrict__ res, size_t i,
                                        float* s) {
  load4<T>(x + i, s);
  if (HAS_RES) {
    float r[4];
    load4<T>(res + i, r);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = svdd::round_to<T>(s[e] + r[e]);
  }
}

template <typename T, bool IM2COL, bool HAS_RES>
__global__ void __launch_bounds__(kThreads, 2)
    attn_pool_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const T* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, T* __restrict__ out,
                     svdd::Taps taps, int k_live, int act, int N, int L,
                     int C) {
  __shared__ __align__(16) float As[2][kBK][kBM + 4];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int lh = (L + 1) / 2;
  const long long rows = static_cast<long long>(N) * lh;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  // A-stage loader: row a_row of the tile, channels a_k .. a_k+3
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  bool a_valid, a_pair;
  size_t a_base;
  {
    const long long row = m0 + a_row;
    a_valid = row < rows;
    const long long nn = a_valid ? row / lh : 0;
    const int p = a_valid ? static_cast<int>(row - nn * lh) : 0;
    a_base = (static_cast<size_t>(nn) * L + 2 * p) * C + a_k;
    a_pair = 2 * p + 1 < L;
  }
  // B-stage loader: k row b_k, columns b_n .. b_n+3
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;

  float a_reg[4], b_reg[4];
  auto load_stage = [&](int k0) {
    if (a_valid) {
      float s0[4], s1[4] = {0.f, 0.f, 0.f, 0.f};
      load_s4<T, HAS_RES>(x, res, a_base + k0, s0);
      if (a_pair) load_s4<T, HAS_RES>(x, res, a_base + C + k0, s1);
#pragma unroll
      for (int e = 0; e < 4; ++e) a_reg[e] = svdd::round_to<T>(s0[e] - s1[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a_reg[e] = 0.f;
    }
    load4<T>(w + static_cast<size_t>(k0 + b_k) * C + n0 + b_n, b_reg);
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) As[buf][a_k + e][a_row] = a_reg[e];
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) =
        make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = C / kBK;
  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_stage((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_stage(cur ^ 1);
    __syncthreads();
  }

  // epilogue: thread rows ty*4+{0..3} and 64+ty*4+{0..3}, columns
  // tx*4+{0..3} and 64+tx*4+{0..3}
  const bool odd = L & 1;
  const size_t kc = static_cast<size_t>(k_live) * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= rows) continue;
    const long long nn = row / lh;
    const int p = static_cast<int>(row - nn * lh);
    const size_t base = (static_cast<size_t>(nn) * L + 2 * p) * C;
    const bool pair = 2 * p + 1 < L;
    const bool tail = odd && p == lh - 1;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      float s0[4], s1[4] = {0.f, 0.f, 0.f, 0.f}, o[4];
      load_s4<T, HAS_RES>(x, res, base + col, s0);
      if (pair) load_s4<T, HAS_RES>(x, res, base + C + col, s1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = s0[e] - s1[e];
        const float wgt = tail ? 1.f : svdd::sigmoid(acc[i][g * 4 + e]);
        o[e] = s1[e] + d * wgt;
      }
      if (!IM2COL) {
        store4<T>(out + (static_cast<size_t>(nn) * lh + p) * C + col, o);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = svdd::round_to<T>(
              svdd::activate(act, o[e] * scale[col + e] + shift[col + e]));
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        for (int t = 0; t < k_live; ++t) {
          const int off = taps.off[t];
          const int q = p - off;  // the cols row that reads this pooled row
          if (q >= 0 && q < lh)
            store4<T>(out + (static_cast<size_t>(nn) * lh + q) * kc + t * C + col, o);
          const int src = p + off;  // this cols row reads outside: zero
          if (src < 0 || src >= lh)
            store4<T>(out + (static_cast<size_t>(nn) * lh + p) * kc + t * C + col, zero);
        }
      }
    }
  }
}

template <typename T, bool IM2COL>
int launch(const void* x, const void* res, const void* w, const void* scale,
           const void* shift, void* out, const int* offsets, int k_live,
           int act, int n, int l, int c, cudaStream_t stream) {
  const long long rows = static_cast<long long>(n) * ((l + 1) / 2);
  dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM), c / kBN);
  const svdd::Taps taps = svdd::make_taps(offsets, k_live);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const T* wp = static_cast<const T*>(w);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  T* op = static_cast<T*>(out);
  if (res)
    attn_pool_kernel<T, IM2COL, true><<<grid, kThreads, 0, stream>>>(
        xp, rp, wp, sp, hp, op, taps, k_live, act, n, l, c);
  else
    attn_pool_kernel<T, IM2COL, false><<<grid, kThreads, 0, stream>>>(
        xp, rp, wp, sp, hp, op, taps, k_live, act, n, l, c);
  return cudaGetLastError();
}

bool bad_shape(int n, int l, int c) {
  return n < 1 || l < 1 || c < kBN || c % kBN;
}

}  // namespace

// x, residual (nullable) (N, L, C), w (C, C) in the activation type;
// out (N, ceil(L/2), C); C a multiple of 128. dtype: 0 float32,
// 1 bfloat16.
extern "C" int svdd_attn_pool(const void* x, const void* res, const void* w,
                              void* out, int n, int l, int c, int dtype,
                              void* stream) {
  if (bad_shape(n, l, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(x, res, w, nullptr, nullptr, out, nullptr, 0, 0, n, l, c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, res, w, nullptr, nullptr, out, nullptr, 0, 0, n, l, c, s);
  return cudaErrorInvalidValue;
}

// As svdd_attn_pool, then y = act(pooled * scale + shift) (scale, shift
// (C,) f32) written as im2col slabs: out (N, ceil(L/2), k_live*C);
// offsets (k_live,) host ints, the live tap offsets at the pooled length.
extern "C" int svdd_attn_pool_im2col(const void* x, const void* res,
                                     const void* w, const void* scale,
                                     const void* shift, void* out,
                                     const void* offsets, int k_live, int act,
                                     int n, int l, int c, int dtype,
                                     void* stream) {
  if (bad_shape(n, l, c) || k_live < 1 || k_live > svdd::kMaxTaps)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(x, res, w, scale, shift, out, offs, k_live, act, n, l, c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(x, res, w, scale, shift, out, offs, k_live, act, n, l, c, s);
  return cudaErrorInvalidValue;
}
