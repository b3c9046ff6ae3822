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
#include "cnn_layer.cuh"

namespace {

using svdd::cnn::kC;
using svdd::cnn::kChunk;
using svdd::cnn::kThreads;
using svdd::cnn::kTileRows;

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
  const T* xn = x + static_cast<size_t>(n) * L * kC;
  int lo, hi;
  svdd::cnn::tile_halo(taps, k_live, L, r0, &lo, &hi);
  svdd::cnn::ln_prologue<T>(xn, bias_row + static_cast<size_t>(n) * kC, ln_g,
                            ln_b, eps, lo, hi, hs);
  float acc[4][8];
  svdd::cnn::tap_products<T>(hs, w, taps, k_live, L, r0, ws, acc);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T* on = out + static_cast<size_t>(n) * L * kC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      const float y = svdd::cnn::conv_out<T>(acc[i][j], cb[col]);
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
  const size_t smem = svdd::cnn::smem_bytes<T>(l);
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
