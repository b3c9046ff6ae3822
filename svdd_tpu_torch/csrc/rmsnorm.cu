// Fused residual add + RMSNorm over the last dimension, per row:
//   v = x [+ residual]                      (in the activation type)
//   out = (v * rsqrt(mean(v^2) + eps)) * scale
// with the mean of squares in f32 and, as the TPU kernel and its jnp
// reference do, the reciprocal root rounded to the activation type
// before the first product and each product rounded to it.
//
// Replaces svdd_tpu/ops/norms.py:_rmsnorm_pallas (pallas_call :75, body
// kernel :57-67; reference _rmsnorm_ref :20).
//
// What bounds it on an H100: device-memory traffic, one read of x (and
// the residual) and one write of out per element against 4 flops. One
// warp per row: the lanes stride over the row, so a warp's loads are
// contiguous, the sum of squares is a shuffle reduction, and the second
// pass re-reads the row from L1 rather than device memory (a DiMamba row
// is 256 values). The TPU kernel's block of rows is the grid of warps
// here; no block needs more than its own row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const T* __restrict__ scale, T* __restrict__ out,
                   long long rows, int d, float eps) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  const T* rr = res ? res + static_cast<size_t>(row) * d : nullptr;
  T* o = out + static_cast<size_t>(row) * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    float v = svdd::to_f(xr[c]);
    if (rr) v = svdd::round_to<T>(v + svdd::to_f(rr[c]));
    ss = fmaf(v, v, ss);
  }
  const float var = svdd::warp_sum(ss) / static_cast<float>(d);
  const float r = svdd::round_to<T>(1.f / sqrtf(var + eps));
  for (int c = lane; c < d; c += 32) {
    float v = svdd::to_f(xr[c]);
    if (rr) v = svdd::round_to<T>(v + svdd::to_f(rr[c]));
    const float y = svdd::round_to<T>(v * r);
    o[c] = svdd::from_f<T>(y * svdd::to_f(scale[c]));
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* scale, void* out,
           long long rows, int d, float eps, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  rmsnorm_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(scale), static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out (rows, d) and the optional residual (rows, d, or null) in the
// activation type; scale (d,) in the same type. dtype: 0 float32,
// 1 bfloat16.
extern "C" int svdd_rmsnorm(const void* x, const void* res, const void* scale,
                            void* out, long long rows, int d, float eps,
                            int dtype, void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, res, scale, out, rows, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, res, scale, out, rows, d, eps, s);
  return cudaErrorInvalidValue;
}
