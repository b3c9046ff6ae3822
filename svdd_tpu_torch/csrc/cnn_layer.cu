// One CNN denoiser layer, fused:
//   out = relu(conv_k_dil(LN(x + bias_row) * g + b) + conv_bias) + x
// with LayerNorm in f32 (eps given) and taps whose |offset| >= L
// dropped (the caller passes only the live taps' offsets and weights).
//
// Replaces svdd_tpu/ops/cnn_layer_pallas.py:_cnn_layer_pallas_jit
// (pallas_call at :234, body _kernel :114).
//
// What bounds it on an H100: the tap products, 2 C^2 per (row, live
// tap) whose source row lies inside the sequence: 496 GFLOP for the 20
// layers of one denoiser forward at N = 512, L = 200, C = 128; 3.0 ms
// on the tensor cores as 3xTF32 (495/3 TFLOP/s) in f32, 0.50 ms in bf16.
// Device-memory traffic is only x, the bias row, the weights and the
// output. Design (cnn_layer.cuh): one block per (sequence, pass of up
// to 240 rows) normalises the rows its taps read into shared memory
// (in x's type, as the reference casts h before the conv), streams each
// live tap's weight through a cp.async ring, and accumulates the tap
// products on the tensor cores, bf16 mma or 3xTF32, in f32. Conv bias,
// relu and the residual add run on the accumulators, so h and y never
// reach device memory.
//
// Rounding points: those of the plain version (ops/cnn_layer.py, after
// cnn_layer_reference), so in bf16 the two differ only by the order of
// the f32 tap sums (and in f32 by 3xTF32's ~2^-20 a product). Values are
// rounded to the activation type T after x + bias_row, after the
// normalisation, after the LN scale and after its bias (g and b
// themselves rounded to T), after the tap sum, after the conv bias add,
// and once more after the residual add. In float32 every one of these
// is exact.
#include "cnn_layer.cuh"

namespace {

using svdd::cnn::kC;
using svdd::cnn::kMaxM;
using svdd::cnn::kNT;
using svdd::cnn::kPassRows;
using svdd::cnn::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    cnn_layer_kernel(const T* __restrict__ x, const T* __restrict__ bias_row,
                     const float* __restrict__ ln_g,
                     const float* __restrict__ ln_b,
                     const T* __restrict__ wt, const float* __restrict__ cb,
                     T* __restrict__ out, svdd::Taps taps, int k_live, int L,
                     float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = svdd::cnn::seq_rows<T>(smem);

  const int n = blockIdx.y;
  const svdd::cnn::Pass p = svdd::cnn::make_pass(taps, k_live, L);
  const T* xn = x + static_cast<size_t>(n) * L * kC;
  svdd::cnn::prefetch_weights<T>(wt, k_live, smem);
  svdd::cnn::ln_prologue<T>(xn, bias_row + static_cast<size_t>(n) * kC, ln_g,
                            ln_b, eps, p.lo, p.hi, L, hs);
  float acc[kMaxM][kNT][4];
  svdd::cnn::tap_products<T>(hs, wt, taps, k_live, L, p, smem, acc);

  // relu(y), exact in T, staged in hs; then out = T(relu(y) + x) over
  // whole rows, 16 bytes a thread a step
  __syncthreads();  // every warp is past the tap loop: hs is free
  svdd::cnn::stage_rows<T>(p, L, acc, hs, [&](float a, int col) {
    return fmaxf(svdd::cnn::conv_out<T>(a, cb[col]), 0.f);
  });
  __syncthreads();
  constexpr int kE = 16 / sizeof(T), kChunks = kC / kE;
  T* on = out + static_cast<size_t>(n) * L * kC;
#pragma unroll 4
  for (int e = threadIdx.x; e < p.rows * kChunks; e += kThreads) {
    const int r = p.r0 + e / kChunks, c = e % kChunks;
    float y[kE], xv[kE];
    svdd::cnn::unpack16<T>(*reinterpret_cast<const uint4*>(hs + r * svdd::cnn::ld<T>() + c * kE), y);
    svdd::cnn::unpack16<T>(*reinterpret_cast<const uint4*>(xn + r * kC + c * kE), xv);
#pragma unroll
    for (int j = 0; j < kE; ++j) y[j] += xv[j];
    *reinterpret_cast<uint4*>(on + r * kC + c * kE) = svdd::cnn::pack16<T>(y);
  }
}

template <typename T>
int launch(const void* x, const void* bias_row, const void* ln_g,
           const void* ln_b, const void* wt, const void* cb, void* out,
           const int* offsets, int k_live, int n, int l, float eps,
           cudaStream_t stream) {
  const size_t smem = svdd::cnn::smem_bytes<T>(l);
  if (smem > static_cast<size_t>(svdd::cnn::kSmemMax)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cnn_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((l + kPassRows - 1) / kPassRows, n);
  cnn_layer_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias_row),
      static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(wt), static_cast<const float*>(cb),
      static_cast<T*>(out), svdd::make_taps(offsets, k_live), k_live, l, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out (N, L, 128) and bias_row (N, 128) in the activation type;
// ln_g, ln_b, cb (128,) f32; wt (k_live, 128, 128) the live-tap weights
// in the activation type, each transposed to [out][in]; offsets
// (k_live,) host ints, ascending and symmetric. The sequence must fit a
// block's shared memory (svdd::cnn::smem_bytes; the wrapper sends longer
// ones to the plain version). dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_cnn_layer(const void* x, const void* bias_row,
                              const void* ln_g, const void* ln_b,
                              const void* wt, const void* cb, void* out,
                              const void* offsets, int k_live, int n, int l,
                              int c, float eps, int dtype, void* stream) {
  if (c != kC || k_live < 1 || k_live > svdd::kMaxTaps || n < 1 || l < 1)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, bias_row, ln_g, ln_b, wt, cb, out, offs, k_live, n, l, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bias_row, ln_g, ln_b, wt, cb, out, offs, k_live, n, l, eps, s);
  return cudaErrorInvalidValue;
}
