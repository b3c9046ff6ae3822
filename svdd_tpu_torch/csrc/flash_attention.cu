// Multi-head softmax attention of the DiT and AR backbones, optionally
// causal:
//   out[b, i, h] = sum_j p_ij v[b, j, h] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = q[b, i, h] . k[b, j, h] / sqrt(D)
// with s, the row maxima and the row sums in f32, p rounded to v's type
// before the p.v product (f32 accumulate), and the division by the f32
// row sum at the end, as the TPU kernel does.
//
// Replaces svdd_tpu/ops/flash_attention_pallas.py:flash_attention
// (pallas_call :66, body _attn_kernel :31-51).
//
// What bounds it on an H100: operations. At the DiT's shapes (L=1024,
// D=64) a call does 4 L^2 D flops per (batch, head) against 4 L D
// elements moved, some 500 flops per byte in f32, and the path's q, k, v
// are f32, so the products run on the FMA pipes (no TF32). The TPU kernel
// held one (batch, head)'s whole K and V on-chip; a block here holds one
// 64-query tile and streams K and V through shared memory in 64-key tiles
// with an online softmax: a running row maximum m and row sum l, the
// accumulator rescaled by exp(m_old - m_new) when the maximum grows. The
// L x L scores never reach device memory. In causal mode the tiles above
// the diagonal are skipped and the longest query tiles are launched
// first. q, k and v are read in their (B, L, H, D) layout by stride, so
// the TPU wrapper's three transposes are not made.
//
// Rounding: p is rounded to v's type against the running maximum, not
// the row's final one. In bf16 that rounding can land one bf16 ulp
// apart from the TPU kernel's for rows whose maximum grows after the
// first tile, and the plain version (svdd_tpu_torch/ops/attention.py:mha)
// rounds the normalised probabilities: a bf16 ulp of a term of the p.v
// sum either way. In f32 only the summation order differs.
//
// Tiles: 256 threads as 16 x 16; thread (ty, tx) holds the scores of
// queries 4ty..4ty+3 against keys 4tx..4tx+3 of the tile and the output
// of the same queries at D/16 columns. Q and K sit transposed in shared
// memory ([d][row]) and p transposed ([key][query]), so the inner loops
// read float4s: one broadcast, one contiguous.
#include "common.cuh"

namespace {

constexpr int kTile = 64;       // queries per block, keys per K/V tile
constexpr int kPad = 4;         // keeps float4 alignment of every row
constexpr int kThreads = 256;

template <int HD>
constexpr size_t smem_floats() {
  // Qt [HD][kTile+kPad], Kt [HD][kTile+kPad], V [kTile][HD+kPad],
  // Pt [kTile][kTile+kPad]
  return static_cast<size_t>(2 * HD * (kTile + kPad) + kTile * (HD + kPad) +
                             kTile * (kTile + kPad));
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int L,
                           int H, int qsb, int qsl, int qsh, int ksb, int ksl,
                           int ksh, int vsb, int vsl, int vsh, float scale,
                           int causal) {
  constexpr int kLdT = kTile + kPad;   // rows of Qt, Kt, Pt
  constexpr int kLdV = HD + kPad;      // rows of V
  constexpr int kCols = HD / 16;       // output columns per thread
  static_assert(kCols % 4 == 0, "HD must be a multiple of 64");
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + HD * kLdT;
  float* Vs = Kt + HD * kLdT;
  float* Pt = Vs + kTile * kLdV;

  const int n_qt = (L + kTile - 1) / kTile;
  // causal: the longest query tiles first, so they do not trail the grid
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const T* qb = q + static_cast<size_t>(b) * qsb + static_cast<size_t>(h) * qsh;
  const T* kb = k + static_cast<size_t>(b) * ksb + static_cast<size_t>(h) * ksh;
  const T* vb = v + static_cast<size_t>(b) * vsb + static_cast<size_t>(h) * vsh;

  // the query tile, transposed; rows past L are zero and never written
  for (int idx = tid; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    Qt[d * kLdT + r] =
        row < L ? svdd::to_f(qb[static_cast<size_t>(row) * qsl + d]) : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = causal ? min(qt + 1, n_qt) : n_qt;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the previous tile's Kt, Vs and Pt are consumed
    for (int idx = tid; idx < kTile * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int key = k0 + r;
      const bool in = key < L;
      Kt[d * kLdT + r] = in ? svdd::to_f(kb[static_cast<size_t>(key) * ksl + d]) : 0.f;
      Vs[r * kLdV + d] = in ? svdd::to_f(vb[static_cast<size_t>(key) * vsl + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLdT + 4 * ty]);
      const float4 bk = *reinterpret_cast<const float4*>(&Kt[d * kLdT + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * tx + j;
        const bool live = key < L && (!causal || key <= row);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mt));
      // tile 0 holds key 0, which every row may attend: m_new is finite
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rs += p[i][j];
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    // p rounded to v's type, as the TPU kernel casts it before p.v
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 pv = make_float4(svdd::round_to<T>(p[0][j]), svdd::round_to<T>(p[1][j]),
                                    svdd::round_to<T>(p[2][j]), svdd::round_to<T>(p[3][j]));
      *reinterpret_cast<float4*>(&Pt[(4 * tx + j) * kLdT + 4 * ty]) = pv;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[j * kLdT + 4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[kCols];
#pragma unroll
      for (int c4 = 0; c4 < kCols; c4 += 4) {
        const float4 bb = *reinterpret_cast<const float4*>(&Vs[j * kLdV + tx * kCols + c4]);
        bv[c4] = bb.x;
        bv[c4 + 1] = bb.y;
        bv[c4 + 2] = bb.z;
        bv[c4 + 3] = bb.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }

  // out is (B, L, H, HD), contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
    const float inv = 1.f / l[i];
    T* o = out + ((static_cast<size_t>(b) * L + row) * H + h) * HD + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c] = svdd::from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L,
           int H, const int* st, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((L + kTile - 1) / kTile, B * H);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), L, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int L,
             int H, int D, const int* st, float scale, int causal, cudaStream_t s) {
  // the head dims built: the presets' 64 and 128 (e.g. the text preset
  // at 6 heads); the tiles take any multiple of 64, and any other D is
  // refused here and by the wrapper
  if (D == 64) return launch<T, 64>(q, k, v, out, B, L, H, st, scale, causal, s);
  if (D == 128) return launch<T, 128>(q, k, v, out, B, L, H, st, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v (B, L, H, D) in the activation type, each with unit stride
// over D and element strides (batch, position, head) in st[0..2] (q),
// st[3..5] (k), st[6..8] (v); out (B, L, H, D) contiguous in the same
// type. D is 64 or 128. scale: 1/sqrt(D). dtype: 0 float32,
// 1 bfloat16.
extern "C" int svdd_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int L, int H, int D,
                                    int qsb, int qsl, int qsh, int ksb, int ksl,
                                    int ksh, int vsb, int vsl, int vsh,
                                    float scale, int causal, int dtype,
                                    void* stream) {
  // grid.y is B * H, at most 65535
  if (B < 1 || L < 1 || H < 1 || static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;
  const int st[9] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, out, B, L, H, D, st, scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, L, H, D, st, scale, causal, s);
  return cudaErrorInvalidValue;
}
