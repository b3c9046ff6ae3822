// Enformer relative-position multi-head attention at sequence length 2,
// everything between the q/k/v projections and to_out:
//   for query i and head h, with q pre-scaled by 1/sqrt(dk),
//   diff = sum_e T(q_i + bc)(k_0 - k_1) + T(q_i + bp)(relk_{0-i} - relk_{1-i})
//   w = sigmoid(diff)            (the 2-way softmax weight of key 0)
//   out_i = w * v_0 + (1 - w) * v_1   over the head's dv lanes
// relk holds the rel_k rows of distances -1, 0, +1 (logit[i, j] uses
// distance j - i, as svdd_tpu/ops/attn_l2_pallas.py:_prep_relk); T()
// rounds to the activation type, as the plain version adds q and the
// bias in that type before its f32 products.
//
// Replaces svdd_tpu/ops/attn_l2_pallas.py:attn_l2_lnc_pallas
// (pallas_call :260, body _kernel_lnc :220), and computes the function of
// attn_l2_pallas (:141), the port keeping one (N, 2, H*d) layout.
//
// What bounds it on an H100: device-memory traffic. Per candidate, q, k
// (2 x H*dk each) and v (2 x H*dv) are read once and out (2 x H*dv) and w
// written once, about 10 bytes a flop: at the value net's 8 heads of
// dk 64 and dv 192 and N = 5120 candidates that is 168 MB in f32,
// 0.050 ms at 3.35 TB/s. Design, one read of every input:
//  * one warp per candidate serves both queries, so k_0, k_1, v_0 and
//    v_1 are read once (a warp per (candidate, query) read them twice);
//  * loads and stores of KE elements, neighbouring lanes of a head on
//    neighbouring addresses: 16 bytes where a head's dk and dv allow
//    (the value net's heads), else the widest of 8, 4 and one element;
//  * all heads at once: a group of lanes a head (32 / H, down to a power
//    of two: 4 at the value net's 8 heads) owns its dk and dv chunks, so
//    each head's two logit sums are a few shfl_xor steps inside its
//    group, with no loop over the heads; past 32 heads a lane a head,
//    32 heads a pass;
//  * bc, bp and relk, the same for every candidate, come from L1;
//  * warps stride over the candidates, the grid sized to the card.
// It takes every shape: any N, any number of heads, any head widths.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, each a candidate at a time

template <typename T, int KE>
__global__ void __launch_bounds__(kThreads)
    attn_l2_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ bc,
                   const T* __restrict__ bp, const T* __restrict__ relk,
                   T* __restrict__ out, float* __restrict__ wout, int N, int H,
                   int dk, int dv, int lph) {
  const int hdk = H * dk, hdv = H * dv;
  const int lane = threadIdx.x & 31;
  const int g = lane / lph, r = lane - g * lph;  // lane group, lane in it
  const int per_pass = 32 / lph;                 // heads a pass of the warp
  const int warps = gridDim.x * (kThreads / 32);
  for (int n = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); n < N; n += warps) {
    const T* qn = q + static_cast<size_t>(n) * 2 * hdk;
    const T* kn = k + static_cast<size_t>(n) * 2 * hdk;
    const T* vn = v + static_cast<size_t>(n) * 2 * hdv;
    T* on = out + static_cast<size_t>(n) * 2 * hdv;
    for (int h0 = 0; h0 < H; h0 += per_pass) {  // the same for the whole warp
      const int h = h0 + g;
      const bool live = h < H;  // lanes past the last head's group idle
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
      for (int c = h * dk + r * KE; live && c < (h + 1) * dk; c += lph * KE) {
        float q0[KE], q1[KE], k0[KE], k1[KE], b_c[KE], b_p[KE], rm[KE], r0[KE], rp[KE];
        svdd::load_packed<T, KE>(qn + c, q0);
        svdd::load_packed<T, KE>(qn + hdk + c, q1);
        svdd::load_packed<T, KE>(kn + c, k0);
        svdd::load_packed<T, KE>(kn + hdk + c, k1);
        // the bias rows: the same for every candidate, read from L1
        svdd::load_packed<T, KE>(bc + c, b_c);
        svdd::load_packed<T, KE>(bp + c, b_p);
        svdd::load_packed<T, KE>(relk + c, rm);            // distance -1
        svdd::load_packed<T, KE>(relk + hdk + c, r0);      // 0
        svdd::load_packed<T, KE>(relk + 2 * hdk + c, rp);  // +1
#pragma unroll
        for (int e = 0; e < KE; ++e) {
          const float kd = k0[e] - k1[e];
          // query 0 reads distances 0 and +1, query 1 distances -1 and 0
          s0 += svdd::round_to<T>(q0[e] + b_c[e]) * kd +
                svdd::round_to<T>(q0[e] + b_p[e]) * (r0[e] - rp[e]);
          s1 += svdd::round_to<T>(q1[e] + b_c[e]) * kd +
                svdd::round_to<T>(q1[e] + b_p[e]) * (rm[e] - r0[e]);
        }
      }
      for (int o = lph / 2; o > 0; o >>= 1) {  // within the head's lane group
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (!live) continue;  // the warp's last pass
      const float w0 = svdd::sigmoid(s0), w1 = svdd::sigmoid(s1);
      if (r == 0) {
        wout[(static_cast<size_t>(n) * 2) * H + h] = w0;
        wout[(static_cast<size_t>(n) * 2 + 1) * H + h] = w1;
      }
#pragma unroll 4
      for (int c = h * dv + r * KE; c < (h + 1) * dv; c += lph * KE) {
        float v0[KE], v1[KE], o0[KE], o1[KE];
        svdd::load_packed<T, KE>(vn + c, v0);
        svdd::load_packed<T, KE>(vn + hdv + c, v1);
#pragma unroll
        for (int e = 0; e < KE; ++e) {
          o0[e] = w0 * v0[e] + (1.f - w0) * v1[e];
          o1[e] = w1 * v0[e] + (1.f - w1) * v1[e];
        }
        svdd::store_packed<T, KE>(on + c, o0);
        svdd::store_packed<T, KE>(on + hdv + c, o1);
      }
    }
  }
}

template <typename T, int KE>
int launch(const void* q, const void* k, const void* v, const void* bc,
           const void* bp, const void* relk, void* out, void* w, int n, int h,
           int dk, int dv, cudaStream_t stream) {
  if constexpr (KE > 1) {  // the widest chunk dividing both head widths
    if (dk % KE || dv % KE)
      return launch<T, KE / 2>(q, k, v, bc, bp, relk, out, w, n, h, dk, dv, stream);
  }
  int lph = 32;  // lanes a head: the largest power of two with h * lph <= 32
  while (lph > 1 && h * lph > 32) lph /= 2;
  // enough blocks to fill the card a few times over, each warp then
  // striding over the candidates
  const int per_block = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>(
      std::min<long long>((static_cast<long long>(n) + per_block - 1) / per_block,
                          16LL * svdd::sm_count()));
  attn_l2_kernel<T, KE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bc),
      static_cast<const T*>(bp), static_cast<const T*>(relk),
      static_cast<T*>(out), static_cast<float*>(w), n, h, dk, dv, lph);
  return cudaGetLastError();
}

}  // namespace

// q, k (N, 2, H*dk) with q pre-scaled; v (N, 2, H*dv); bc, bp (H*dk,);
// relk (3, H*dk) in the activation type; out (N, 2, H*dv) in the
// activation type, w (N, 2, H) f32. Every tensor 16-byte aligned.
// dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_attn_l2(const void* q, const void* k, const void* v,
                            const void* bc, const void* bp, const void* relk,
                            void* out, void* w, int n, int h, int dk, int dv,
                            int dtype, void* stream) {
  if (n < 1 || h < 1 || dk < 1 || dv < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, 4>(q, k, v, bc, bp, relk, out, w, n, h, dk, dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8>(q, k, v, bc, bp, relk, out, w, n, h, dk, dv, s);
  return cudaErrorInvalidValue;
}
