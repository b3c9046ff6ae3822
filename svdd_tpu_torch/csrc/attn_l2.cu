// Enformer relative-position multi-head attention at sequence length 2,
// everything between the q/k/v projections and to_out:
//   for query i and head h, with q pre-scaled by 1/sqrt(dk),
//   diff = sum_e (q_i + bc)(k_0 - k_1) + (q_i + bp)(relk_{0-i} - relk_{1-i})
//   w = sigmoid(diff)            (the 2-way softmax weight of key 0)
//   out_i = w * v_0 + (1 - w) * v_1   over the head's dv lanes
// relk holds the rel_k rows of distances -1, 0, +1 (logit[i, j] uses
// distance j - i, as svdd_tpu/ops/attn_l2_pallas.py:_prep_relk).
//
// Replaces svdd_tpu/ops/attn_l2_pallas.py:attn_l2_lnc_pallas
// (pallas_call :260, body _kernel_lnc :220).
//
// What bounds it on an H100: device-memory traffic, q and k (2 * H*dk)
// and v (2 * H*dv) per candidate read, out (2 * H*dv) and w written,
// about 10 bytes per flop. One warp per (candidate, query) row loops
// over the heads: the per-head sum over dk is a warp shuffle reduction
// (the TPU's 0/1 head-selector matmuls are not needed), then the warp
// writes the head's blended dv lanes.
#include "common.cuh"

namespace {

template <typename T>
__global__ void attn_l2_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ bc,
                               const T* __restrict__ bp,
                               const T* __restrict__ relk, T* __restrict__ out,
                               float* __restrict__ wout, int N, int H, int dk,
                               int dv) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= 2LL * N) return;
  const long long n = row >> 1;
  const int i = static_cast<int>(row & 1);
  const int hdk = H * dk, hdv = H * dv;
  const T* qr = q + static_cast<size_t>(row) * hdk;
  const T* k0 = k + static_cast<size_t>(n) * 2 * hdk;
  const T* k1 = k0 + hdk;
  // relk rows: 0 -> distance -1, 1 -> 0, 2 -> +1
  const T* ra = relk + static_cast<size_t>(i == 0 ? 1 : 0) * hdk;  // j=0
  const T* rb = relk + static_cast<size_t>(i == 0 ? 2 : 1) * hdk;  // j=1
  const T* v0 = v + static_cast<size_t>(n) * 2 * hdv;
  const T* v1 = v0 + hdv;
  T* o = out + static_cast<size_t>(row) * hdv;
  for (int h = 0; h < H; ++h) {
    float s = 0.f;
    for (int e = lane; e < dk; e += 32) {
      const int c = h * dk + e;
      // q + bias is rounded to the activation type, as the reference
      // adds them in that type before the f32 products
      const float qv = svdd::to_f(qr[c]);
      const float qc = svdd::round_to<T>(qv + svdd::to_f(bc[c]));
      const float qp = svdd::round_to<T>(qv + svdd::to_f(bp[c]));
      s += qc * (svdd::to_f(k0[c]) - svdd::to_f(k1[c])) +
           qp * (svdd::to_f(ra[c]) - svdd::to_f(rb[c]));
    }
    const float wgt = svdd::sigmoid(svdd::warp_sum(s));
    if (lane == 0) wout[static_cast<size_t>(row) * H + h] = wgt;
    for (int e = lane; e < dv; e += 32) {
      const int c = h * dv + e;
      o[c] = svdd::from_f<T>(wgt * svdd::to_f(v0[c]) +
                             (1.f - wgt) * svdd::to_f(v1[c]));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bc,
           const void* bp, const void* relk, void* out, void* w, int n, int h,
           int dk, int dv, cudaStream_t stream) {
  const int threads = 256;  // 8 rows per block
  const long long rows = 2LL * n;
  const unsigned blocks = static_cast<unsigned>((rows * 32 + threads - 1) / threads);
  attn_l2_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bc),
      static_cast<const T*>(bp), static_cast<const T*>(relk),
      static_cast<T*>(out), static_cast<float*>(w), n, h, dk, dv);
  return cudaGetLastError();
}

}  // namespace

// q, k (N, 2, H*dk) with q pre-scaled; v (N, 2, H*dv); bc, bp (H*dk,);
// relk (3, H*dk) in the activation type. out (N, 2, H*dv) in the
// activation type, w (N, 2, H) f32. dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_attn_l2(const void* q, const void* k, const void* v,
                            const void* bc, const void* bp, const void* relk,
                            void* out, void* w, int n, int h, int dk, int dv,
                            int dtype, void* stream) {
  if (n < 1 || h < 1 || dk < 1 || dv < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, bc, bp, relk, out, w, n, h, dk, dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bc, bp, relk, out, w, n, h, dk, dv, s);
  return cudaErrorInvalidValue;
}
