// Pieces of the CNN denoiser layer shared by its forward (B1,
// cnn_layer.cu) and its backward (B6, cnn_layer_bwd.cu). The backward
// rebuilds the relu mask by running exactly this code on the same
// inputs, so the recomputed conv output, and hence the mask, is the
// forward's bit for bit, in bf16 too.
//
// Block geometry: one block of 256 threads per (sequence, 64-row output
// tile); thread (tx, ty) = (tid % 16, tid / 16) owns rows r0+ty+16i
// (i < 4) and channels tx+16j (j < 8).
#pragma once

#include "common.cuh"

namespace svdd {
namespace cnn {

constexpr int kC = 128;        // channels (the denoiser's hidden size)
constexpr int kTileRows = 64;  // output rows per block
constexpr int kChunk = 16;     // input channels per weight stage
constexpr int kThreads = 256;

// Dynamic shared memory of a block: one f32 weight chunk, then the
// [L][kC] sequence in T.
template <typename T>
inline size_t smem_bytes(int l) {
  return kChunk * kC * sizeof(float) + static_cast<size_t>(l) * kC * sizeof(T);
}

// Rows [lo, hi] of the sequence the taps of the tile starting at r0 read.
__device__ __forceinline__ void tile_halo(const Taps& taps, int k_live,
                                          int L, int r0, int* lo, int* hi) {
  const int last = min(r0 + kTileRows, L) - 1;
  *lo = max(r0 + taps.off[0], 0);
  *hi = min(last + taps.off[k_live - 1], L - 1);
}

// LayerNorm statistics of one row, one warp per row, 4 channels a lane:
// v[j] = T(x + bias_row) at channel lane + 32j, its mean and 1/std in f32.
template <typename T>
__device__ __forceinline__ void ln_row(const T* __restrict__ xr,
                                       const float* br, int lane, float eps,
                                       float* v, float* mu, float* rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = round_to<T>(to_f(xr[lane + 32 * j]) + br[j]);
    s += v[j];
  }
  *mu = warp_sum(s) * (1.f / kC);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) q += (v[j] - *mu) * (v[j] - *mu);
  *rstd = rsqrtf(warp_sum(q) * (1.f / kC) + eps);
}

// hs[r] = T(T(T(LN(x + bias_row)) * T(g)) + T(b)) for rows lo..hi: the
// conv input, rounded where cnn_layer_reference rounds.
template <typename T>
__device__ __forceinline__ void ln_prologue(const T* __restrict__ xn,
                                            const T* __restrict__ bias_row_n,
                                            const float* __restrict__ ln_g,
                                            const float* __restrict__ ln_b,
                                            float eps, int lo, int hi,
                                            T* hs) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float br[4], g[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = lane + 32 * j;
    br[j] = to_f(bias_row_n[ch]);
    g[j] = round_to<T>(ln_g[ch]);
    b[j] = round_to<T>(ln_b[ch]);
  }
  for (int r = lo + warp; r <= hi; r += kThreads / 32) {
    float v[4], mu, rstd;
    ln_row<T>(xn + r * kC, br, lane, eps, v, &mu, &rstd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hn = round_to<T>((v[j] - mu) * rstd);
      hs[r * kC + lane + 32 * j] = from_f<T>(round_to<T>(hn * g[j]) + b[j]);
    }
  }
}

// acc[i][j] = sum over live taps t of (hs[row + off_t] @ w[t])[col] for
// row = r0+ty+16i, col = tx+16j, zero where row + off_t is outside
// [0, L): each tap's weight streams through the f32 chunk ws, 16 input
// channels at a time. w is (k_live, kC, kC) in T, [t][in][out].
template <typename T>
__device__ __forceinline__ void tap_products(const T* hs,
                                             const T* __restrict__ w,
                                             const Taps& taps, int k_live,
                                             int L, int r0, float* ws,
                                             float (&acc)[4][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
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
        ws[e] = to_f(wt[static_cast<size_t>(k0) * kC + e]);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = src[i] >= 0 ? to_f(hs[src[i] * kC + k0 + kk]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = ws[kk * kC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }
}

// The conv output with its bias, rounded where the reference rounds:
// y = T(T(acc) + T(conv_bias)); the layer's output is relu(y) + x.
template <typename T>
__device__ __forceinline__ float conv_out(float acc, float cb) {
  return round_to<T>(round_to<T>(acc) + round_to<T>(cb));
}

}  // namespace cnn
}  // namespace svdd
