// M Gumbel-max candidate draws per row for the SVDD guided step:
//   out[b, m, l] = x[b, l]                                if x != MASK
//                = argmax_v(log_q[b, l, v] + G[b, m, l, v]) otherwise
// with G = -log(-log(u + 1e-20) + 1e-20), u ~ U[0, 1), as
// svdd_tpu/ops/fused_sample.py:46-48 makes it.
//
// Replaces svdd_tpu/ops/fused_sample.py:gumbel_candidates_pallas
// (pallas_call :63, body :33).
//
// The noise comes from a counter-based Philox4x32-10 generator written
// into the kernel: key = the 64-bit seed the caller draws from its
// torch.Generator (read from device memory, so the step needs no host
// sync), counter = (l, m, b, v / 4). A draw therefore depends on
// (seed, b, m, l, v) only, never on the launch geometry.
//
// What bounds it on an H100: device-memory traffic, log_q (B*L*V f32)
// read M times from L2 and B*M*L int32 written, about 1 MB per guided
// step at B=512, M=10, L=200; the (B, M, L, V) noise tensor is never
// stored unless the caller asks for it (noise != nullptr, to hold the
// draw against the plain version on the same noise). One thread per
// output element.
#include "common.cuh"

namespace {

struct Philox {
  uint32_t v[4];
};

__device__ __forceinline__ Philox philox4x32_10(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return Philox{{c0, c1, c2, c3}};
}

__global__ void gumbel_candidates_kernel(const float* __restrict__ log_q,
                                         const int* __restrict__ x,
                                         const long long* __restrict__ seed,
                                         int* __restrict__ out,
                                         float* __restrict__ noise, int B,
                                         int M, int L, int V, int mask_index) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(B) * M * L;
  if (idx >= total) return;
  const int l = static_cast<int>(idx % L);
  const int m = static_cast<int>((idx / L) % M);
  const int b = static_cast<int>(idx / (static_cast<long long>(L) * M));
  const int xv = x[static_cast<size_t>(b) * L + l];
  if (xv != mask_index) {
    out[idx] = xv;
    if (noise)
      for (int v = 0; v < V; ++v) noise[idx * V + v] = 0.f;
    return;
  }
  const unsigned long long s = static_cast<unsigned long long>(seed[0]);
  const uint32_t k0 = static_cast<uint32_t>(s), k1 = static_cast<uint32_t>(s >> 32);
  const float* lq = log_q + (static_cast<size_t>(b) * L + l) * V;
  float best = -INFINITY;
  int arg = 0;
  Philox r{};
  for (int v = 0; v < V; ++v) {
    if ((v & 3) == 0) r = philox4x32_10(l, m, b, v >> 2, k0, k1);
    const float u = (r.v[v & 3] >> 8) * (1.0f / 16777216.0f);  // [0, 1)
    const float g = -logf(-logf(u + 1e-20f) + 1e-20f);
    if (noise) noise[idx * V + v] = g;
    const float val = lq[v] + g;
    if (val > best) {  // first maximum wins, as argmax
      best = val;
      arg = v;
    }
  }
  out[idx] = arg;
}

}  // namespace

// log_q (B, L, V) f32, x (B, L) int32, seed (1,) int64 on the device;
// out (B, M, L) int32; noise (B, M, L, V) f32 or null: the Gumbel noise
// of each draw (0 where x is not MASK).
extern "C" int svdd_gumbel_candidates(const void* log_q, const void* x,
                                      const void* seed, void* out,
                                      void* noise, int b,
                                      int m, int l, int v, int mask_index,
                                      void* stream) {
  if (b < 1 || m < 1 || l < 1 || v < 1) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * m * l;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  gumbel_candidates_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_q), static_cast<const int*>(x),
      static_cast<const long long*>(seed), static_cast<int*>(out),
      static_cast<float*>(noise), b, m, l, v, mask_index);
  return cudaGetLastError();
}
