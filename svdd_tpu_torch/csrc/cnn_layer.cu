// One CNN denoiser layer, fused:
//   out = relu(conv_k_dil(LN(x + bias_row) * g + b) + conv_bias) + x
// with LayerNorm in f32 (eps given) and taps whose |offset| >= L
// dropped (the caller passes only the live taps' offsets and weights).
//
// Replaces svdd_tpu/ops/cnn_layer_pallas.py:_cnn_layer_pallas_jit
// (pallas_call at :234, body _kernel :114).
//
// What bounds it on an H100: the tap products, 2*L*k_live*C*C flops
// per sequence (59 MFLOP at L=200, C=128, 9 live taps; 30 GFLOP per
// layer at N=512), on the f32 FMA pipes in this first version (67
// TFLOP/s published peak outside the tensor cores); device-memory traffic is
// only x, the bias row, the weights and the output. Design: one block
// per (sequence, 64-row output tile). The block normalises just the
// rows its taps read into shared memory (stored in x's type, as the
// reference casts h before the conv), then streams each live tap's
// weight through shared memory in 16-channel chunks and accumulates a
// 4x8 register tile per thread in f32. Conv bias, relu and the
// residual add happen in the epilogue, so h never reaches device
// memory.
//
// Rounding points: those of the plain version (ops/cnn_layer.py, after
// cnn_layer_reference), so in bf16 the two differ only by the order of
// the f32 tap sums. Values are rounded to the activation type T after
// x + bias_row, after the normalisation, after the LN scale and after
// its bias (g and b themselves rounded to T), after the tap sum, after
// the conv bias add, and once more after the residual add. In float32
// every one of these is exact.
#include "common.cuh"

namespace {

constexpr int kC = 128;        // channels (the denoiser's hidden size)
constexpr int kTileRows = 64;  // output rows per block
constexpr int kChunk = 16;     // input channels per weight stage
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cnn_layer_kernel(const T* __restrict__ x, const T* __restrict__ bias_row,
                     const float* __restrict__ ln_g,
                     const float* __restrict__ ln_b,
                     const T* __restrict__ w, const float* __restrict__ cb,
                     T* __restrict__ out, svdd::Taps taps, int k_live, int L,
                     float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [kChunk][kC]
  T* hs = reinterpret_cast<T*>(smem + kChunk * kC * sizeof(float));  // [L][kC]

  const int n = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* xn = x + static_cast<size_t>(n) * L * kC;

  // rows of h the taps of this tile read
  const int last = min(r0 + kTileRows, L) - 1;
  const int lo = max(r0 + taps.off[0], 0);
  const int hi = min(last + taps.off[k_live - 1], L - 1);

  // LayerNorm: one warp per row, 4 channels per lane, f32 statistics
  float br[4], g[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = lane + 32 * j;
    br[j] = svdd::to_f(bias_row[static_cast<size_t>(n) * kC + ch]);
    g[j] = svdd::round_to<T>(ln_g[ch]);
    b[j] = svdd::round_to<T>(ln_b[ch]);
  }
  for (int r = lo + warp; r <= hi; r += kThreads / 32) {
    float v[4];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = svdd::round_to<T>(svdd::to_f(xn[r * kC + lane + 32 * j]) + br[j]);
      s += v[j];
    }
    const float mu = svdd::warp_sum(s) * (1.f / kC);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) q += (v[j] - mu) * (v[j] - mu);
    const float rstd = rsqrtf(svdd::warp_sum(q) * (1.f / kC) + eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hn = svdd::round_to<T>((v[j] - mu) * rstd);
      hs[r * kC + lane + 32 * j] =
          svdd::from_f<T>(svdd::round_to<T>(hn * g[j]) + b[j]);
    }
  }

  // tap products: thread (tx, ty) owns rows r0+ty+16i, cols tx+16j
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < k_live; ++t) {
    const int off = taps.off[t];
    const T* wt = w + static_cast<size_t>(t) * kC * kC;
    int src[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = r0 + ty + 16 * i + off;
      src[i] = (s >= 0 && s < L) ? s : -1;
    }
    for (int k0 = 0; k0 < kC; k0 += kChunk) {
      __syncthreads();  // h rows written / previous chunk consumed
      for (int e = tid; e < kChunk * kC; e += kThreads)
        ws[e] = svdd::to_f(wt[static_cast<size_t>(k0) * kC + e]);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = src[i] >= 0 ? svdd::to_f(hs[src[i] * kC + k0 + kk]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = ws[kk * kC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }

  T* on = out + static_cast<size_t>(n) * L * kC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      const float y = svdd::round_to<T>(svdd::round_to<T>(acc[i][j]) +
                                        svdd::round_to<T>(cb[col]));
      const float v = fmaxf(y, 0.f) + svdd::to_f(xn[row * kC + col]);
      on[row * kC + col] = svdd::from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* bias_row, const void* ln_g,
           const void* ln_b, const void* w, const void* cb, void* out,
           const int* offsets, int k_live, int n, int l, float eps,
           cudaStream_t stream) {
  const size_t smem = kChunk * kC * sizeof(float) + static_cast<size_t>(l) * kC * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      cnn_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((l + kTileRows - 1) / kTileRows, n);
  cnn_layer_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias_row),
      static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(w), static_cast<const float*>(cb),
      static_cast<T*>(out), svdd::make_taps(offsets, k_live), k_live, l, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out (N, L, 128) and bias_row (N, 128) in the activation type;
// ln_g, ln_b, cb (128,) f32; w (k_live, 128, 128) live-tap weights in
// the activation type; offsets (k_live,) host ints, ascending.
// dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_cnn_layer(const void* x, const void* bias_row,
                              const void* ln_g, const void* ln_b,
                              const void* w, const void* cb, void* out,
                              const void* offsets, int k_live, int n, int l,
                              int c, float eps, int dtype, void* stream) {
  if (c != kC || k_live < 1 || k_live > svdd::kMaxTaps) return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, bias_row, ln_g, ln_b, w, cb, out, offs, k_live, n, l, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bias_row, ln_g, ln_b, w, cb, out, offs, k_live, n, l, eps, s);
  return cudaErrorInvalidValue;
}
