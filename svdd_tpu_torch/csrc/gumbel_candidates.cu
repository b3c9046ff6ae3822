// M Gumbel-max candidate draws per row for the SVDD guided step:
//   out[b, m, l] = x[b, l]                                if x != MASK
//                = argmax_v(log_q[b, l, v] + G[b, m, l, v]) otherwise
// with G = -log(-log(u + 1e-20) + 1e-20), u ~ U[0, 1) on a 24-bit grid,
// as svdd_tpu/ops/fused_sample.py:46-48 makes it.
//
// Replaces svdd_tpu/ops/fused_sample.py:gumbel_candidates_pallas
// (pallas_call :63, body :33).
//
// The noise comes from a counter-based Philox4x32-10 generator written
// into the kernel: key = the seed of the caller's torch.Generator,
// counter = (l, m | group << 16, row0 + b, the call's Philox offset / 4),
// where group = v / 5: one call's 128 bits hold five 24-bit uniforms (the
// top 24 bits of each word, then the low bytes of words 0-2), so V <= 5
// takes one Philox call a draw. row0 is the global index of the call's
// first row: a process that holds rows [row0, row0 + B) of a batch split
// over processes draws what one call on the whole batch draws for them.
// A draw therefore depends on (seed, offset, row0 + b, m, l, v) only,
// never on the launch geometry.
//
// What bounds it on an H100: at (B, M, L, V) = (512, 10, 200, 5) the
// bytes (log_q read once, x read once, the candidates written once in
// x's type: 11 MB with int64 tokens, 3.3 us at 3.35 TB/s) and, about as
// much, the work of a masked position's draw: one Philox call (40 32-bit
// multiplies) and two logarithms a value. A draw is a few hundred
// instructions, so what is left is latency: a block that loads, waits
// and draws a little hides none of it. Design:
//  * a block covers one row b (a tile of up to 44 KB of its log_q rows
//    where the row is longer) for all M draws, one wave of blocks at the
//    decode's shapes: the row's log_q and tokens are loaded once into
//    shared memory, coalesced, and shared by the M draws;
//  * only masked positions draw, and the block lists them first (a warp
//    ballot a chunk of 32 positions), so no thread idles beside a
//    drawing one: its threads stride over the M x (masked positions)
//    draws, then copy the unmasked tokens, neighbouring threads on
//    neighbouring positions; 32-bit index math from the launch geometry;
//  * one Philox call a draw for V <= 5;
//  * the candidates are written in x's integer type: no cast after.
// The (B, M, L, V) noise is stored only when the caller asks for it
// (noise != nullptr, to hold the draws against the plain version).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// a block's log_q rows, tokens and list, with its static chunk counts
// under the 48 KB a block may take without opting in
constexpr int kTileBytes = 44 * 1024;
constexpr int kMaxTile = 2048;         // positions a block
constexpr int kPerCall = 5;            // 24-bit uniforms one Philox call gives

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

// The j-th 24-bit uniform (j < 5) of one Philox call, in [0, 1).
__device__ __forceinline__ float uniform24(const Philox& r, int j) {
  const uint32_t bits =
      j < 4 ? r.v[j] >> 8
            : (r.v[0] & 0xffu) | ((r.v[1] & 0xffu) << 8) | ((r.v[2] & 0xffu) << 16);
  return static_cast<float>(bits) * (1.0f / 16777216.0f);
}

template <typename TI>
__global__ void __launch_bounds__(kThreads)
    gumbel_candidates_kernel(const float* __restrict__ log_q, const TI* __restrict__ x,
                             TI* __restrict__ out, float* __restrict__ noise, int L,
                             int M, int V, int tile_l, int mask_index, uint32_t row0,
                             uint32_t k0, uint32_t k1, uint32_t call) {
  extern __shared__ float smem[];
  float* lq_tile = smem;                                      // tile_l * V
  int* x_tile = reinterpret_cast<int*>(smem + tile_l * V);  // tile_l
  int* masked = x_tile + tile_l;                              // tile_l
  __shared__ int chunk_start[kMaxTile / 32 + 1];
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * tile_l;
  const int nl = min(tile_l, L - l0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(b) * L + l0;
  // the tile's rows of log_q are contiguous: one coalesced pass
  for (int i = threadIdx.x; i < nl * V; i += kThreads) lq_tile[i] = log_q[row * V + i];
  for (int i = threadIdx.x; i < nl; i += kThreads) x_tile[i] = static_cast<int>(x[row + i]);
  __syncthreads();
  // the list of masked positions: a count a chunk of 32, their running
  // sum, then each masked position at its rank
  const int chunks = (nl + 31) / 32;
  for (int c = warp; c < chunks; c += kThreads / 32) {
    const int l = c * 32 + lane;
    const unsigned ballot = __ballot_sync(0xffffffffu, l < nl && x_tile[l] == mask_index);
    if (lane == 0) chunk_start[c + 1] = __popc(ballot);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    chunk_start[0] = 0;
    for (int c = 0; c < chunks; ++c) chunk_start[c + 1] += chunk_start[c];
  }
  __syncthreads();
  for (int c = warp; c < chunks; c += kThreads / 32) {
    const int l = c * 32 + lane;
    const bool mk = l < nl && x_tile[l] == mask_index;
    const unsigned ballot = __ballot_sync(0xffffffffu, mk);
    if (mk) masked[chunk_start[c] + __popc(ballot & ((1u << lane) - 1u))] = l;
  }
  __syncthreads();
  const int nm = chunk_start[chunks];
  for (int j = threadIdx.x; j < M * nm; j += kThreads) {
    const int m = j / nm, l = masked[j - m * nm];
    const size_t o = (static_cast<size_t>(b) * M + m) * L + l0 + l;
    const float* lq = lq_tile + l * V;
    float best = -INFINITY;
    int arg = 0;
    Philox r{};
    for (int v = 0; v < V; ++v) {
      const int jv = v % kPerCall;
      if (jv == 0)
        r = philox4x32_10(l0 + l, static_cast<uint32_t>(m) | (static_cast<uint32_t>(v / kPerCall) << 16),
                          row0 + b, call, k0, k1);
      const float u = uniform24(r, jv);
      // the inner logarithm near u = 1 needs logf's accuracy (-log u is
      // then about 6e-8); the outer one's argument is at least that
      const float g = -__logf(-logf(u + 1e-20f) + 1e-20f);
      if (noise) noise[o * V + v] = g;
      const float val = lq[v] + g;
      if (val > best) {  // first maximum wins, as argmax
        best = val;
        arg = v;
      }
    }
    out[o] = static_cast<TI>(arg);
  }
  if (nm == nl) return;
  for (int j = threadIdx.x; j < M * nl; j += kThreads) {
    const int m = j / nl, l = j - m * nl;
    const int xv = x_tile[l];
    if (xv == mask_index) continue;
    const size_t o = (static_cast<size_t>(b) * M + m) * L + l0 + l;
    out[o] = static_cast<TI>(xv);
    if (noise)
      for (int v = 0; v < V; ++v) noise[o * V + v] = 0.f;
  }
}

template <typename TI>
int launch(const void* log_q, const void* x, void* out, void* noise, int b, int m,
           int l, int v, int mask_index, int row0, unsigned long long seed,
           unsigned long long offset, cudaStream_t stream) {
  const int per_position = (v + 2) * 4;  // its log_q row, token, list entry
  int tile_l = kTileBytes / per_position;
  if (tile_l < 1) return cudaErrorInvalidValue;
  tile_l = tile_l < kMaxTile ? tile_l : kMaxTile;
  tile_l = tile_l < l ? tile_l : l;
  const dim3 grid((l + tile_l - 1) / tile_l, b);
  gumbel_candidates_kernel<TI><<<grid, kThreads, static_cast<size_t>(tile_l) * per_position,
                                 stream>>>(
      static_cast<const float*>(log_q), static_cast<const TI*>(x),
      static_cast<TI*>(out), static_cast<float*>(noise), l, m, v, tile_l, mask_index,
      static_cast<uint32_t>(row0), static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), static_cast<uint32_t>(offset >> 2));
  return cudaGetLastError();
}

}  // namespace

// log_q (B, L, V) f32, x (B, L) int32 or int64 (index_bits 32 or 64);
// out (B, M, L) of x's type; noise (B, M, L, V) f32 or null: the Gumbel
// noise of each draw (0 where x is not MASK). row0: the global index of
// row 0 (0 for a whole batch). seed and offset: the Philox seed and
// offset of the caller's generator (offset a multiple of 4, advanced by
// the caller past this call).
extern "C" int svdd_gumbel_candidates(const void* log_q, const void* x, void* out,
                                      void* noise, int b, int m, int l, int v,
                                      int mask_index, int index_bits, int row0,
                                      unsigned long long seed,
                                      unsigned long long offset, void* stream) {
  if (b < 1 || m < 1 || l < 1 || v < 1 || b > 65535 || m > 65535 || v > kPerCall * 65535 ||
      row0 < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bits == 64)
    return launch<long long>(log_q, x, out, noise, b, m, l, v, mask_index, row0, seed, offset,
                             s);
  if (index_bits == 32)
    return launch<int>(log_q, x, out, noise, b, m, l, v, mask_index, row0, seed, offset, s);
  return cudaErrorInvalidValue;
}
