// The weight-gradient GEMM of the convolutions' backward on the tensor
// cores, shared by B7 (conv1d_bwd.cu, a block per (row chunk, 128 x 128
// tile of dW_t, live tap)) and B8 (attn_pool_bwd.cu, one tap of offset 0
// over the pooled rows):
//   dW_t[ci][co] = sum over rows r of x[r + off_t][ci] ct[r][co],
// x (N, L, Cin) and ct (N, L, Cout) in the activation type, a source row
// outside its own sequence counting as zero (SAME padding); rows streamed
// through a 3-stage cp.async ring of 64 rows of each operand: the
// template of B6's wgrad (cnn_layer_bwd.cu) with tile offsets and C_in !=
// C_out (bf16: ldmatrix.trans fragments; f32: 3xTF32 on scalar fragment
// loads, 8-element row padding keeping them free of bank conflicts, and a
// partial sum a stage as in conv_mma.cuh's Ring::kFlush). A row chunk's
// partial is summed with the others' by a deterministic second pass
// (reduce.cuh) instead of the TPU's sequential-grid accumulator, or
// written as dW where there is one chunk.
#pragma once

#include "conv_mma.cuh"

namespace svdd {
namespace conv {

// dW_t[a0.., b0..] partial over rows [chunk * rows_per_chunk, ...) of the
// tap of offset off, written at dw_part[tap][chunk] (tap = blockIdx.z,
// chunk = blockIdx.x of gridDim.x, the (a0, b0) tile blockIdx.y); smem
// holds wgrad_smem_bytes<T>(). A block is 8 warps over the 128 x 128
// tile, each 64 x 32 (4 m16 x 4 n8 tiles). 64 rows a stage ran 7% faster
// than 32 in bf16 and the same in f32 on an H100
// (scripts/probe_conv_mma.py, variant wgrad_rows32).
constexpr int kWThreads = 256;  // 8 warps: 2 along the rows of dW, 4 along its columns
constexpr int kWTile = 128;
constexpr int kWRows = 64;
constexpr int kWStages = 3;
constexpr int kWLd = kWTile + 8;  // elements a padded row, f32 or bf16

template <typename T>
constexpr size_t wgrad_smem_bytes() {
  return static_cast<size_t>(2 * kWStages * kWRows * kWLd) * sizeof(T);
}

// blocks an SM: two in bf16; one in f32, whose per-stage partial sums
// (conv_mma.cuh, Ring::kFlush) take the registers of a second
template <typename T>
constexpr int wgrad_blocks() {
  return sizeof(T) == 2 ? 2 : 1;
}

template <typename T>
__device__ __forceinline__ void wgrad_tile(const T* __restrict__ x, const T* __restrict__ ct,
                                           float* __restrict__ dw_part, int off, int N,
                                           int L, int Cin, int Cout, int rows_per_chunk,
                                           unsigned char* smem) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kE = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int kChunks = kWTile / kE;        // chunks a tile row
  T* As = reinterpret_cast<T*>(smem);         // [kWStages][kWRows][kWLd]: x
  T* Bs = As + kWStages * kWRows * kWLd;      // the same for ct

  const int chunk = blockIdx.x, chunks = gridDim.x, tap = blockIdx.z;
  const int tiles_b = Cout / kWTile;
  const int a0 = (blockIdx.y / tiles_b) * kWTile;
  const int b0 = (blockIdx.y % tiles_b) * kWTile;
  const long long total = static_cast<long long>(N) * L;
  const long long r_begin = static_cast<long long>(chunk) * rows_per_chunk;
  const long long r_end = min(total, r_begin + rows_per_chunk);
  const int n_st = r_end > r_begin
                       ? static_cast<int>((r_end - r_begin + kWRows - 1) / kWRows)
                       : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;

  // this thread copies 16-byte chunk c of kSlots rows of each stage,
  // rows tid / kChunks + j * kRowStep; seq and pos hold, for the stage
  // loaded next (stages load in order), the sequence and position of
  // each, advanced by kWRows a stage rather than divided anew
  constexpr int kRowStep = kWThreads / kChunks;
  constexpr int kSlots = kWRows / kRowStep;
  static_assert(kWThreads % kChunks == 0 && kWRows % kRowStep == 0, "slots");
  const int c = tid % kChunks;
  int seq[kSlots], pos[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const long long R = r_begin + tid / kChunks + j * kRowStep;
    seq[j] = static_cast<int>(R / L);
    pos[j] = static_cast<int>(R - static_cast<long long>(seq[j]) * L);
  }
  auto load_stage = [&](int s) {
    const int buf = s % kWStages;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int r = tid / kChunks + j * kRowStep;
      const long long R = r_begin + static_cast<long long>(s) * kWRows + r;
      const bool in = R < r_end;
      const int src = pos[j] + off;
      const bool a_in = in && src >= 0 && src < L;
      const T* a_src =
          a_in ? x + (static_cast<size_t>(seq[j]) * L + src) * Cin + a0 + c * kE : x;
      const T* b_src = in ? ct + static_cast<size_t>(R) * Cout + b0 + c * kE : ct;
      const int at = (buf * kWRows + r) * kWLd + c * kE;
      mma::cp_async16(mma::smem_u32(As + at), a_src, a_in);
      mma::cp_async16(mma::smem_u32(Bs + at), b_src, in);
      for (pos[j] += kWRows; pos[j] >= L; pos[j] -= L) ++seq[j];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < n_st) load_stage(s);
    mma::cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < n_st; ++s) {
    mma::cp_async_wait<kWStages - 2>();
    __syncthreads();
    if (s + kWStages - 1 < n_st) load_stage(s + kWStages - 1);
    mma::cp_async_commit();
    const T* A = As + (s % kWStages) * kWRows * kWLd;
    const T* B = Bs + (s % kWStages) * kWRows * kWLd;
    if constexpr (kBf16) {
      // A[m = ci][k = row] and B[k = row][n = co] are both stored by
      // rows of k, so both fragments come by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kWRows / 16; ++kk) {
        uint32_t a[4][4], b[4][2];
        const int j = lane >> 3;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int kr = 16 * kk + (j >> 1) * 8 + (lane & 7);
          const int m = 64 * wm + 16 * mi + (j & 1) * 8;
          mma::ldsm_x4_trans(a[mi], mma::smem_u32(A + kr * kWLd + m));
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kr = 16 * kk + (j & 1) * 8 + (lane & 7);
          const int nn = 32 * wn + 16 * q + (j >> 1) * 8;
          uint32_t r[4];
          mma::ldsm_x4_trans(r, mma::smem_u32(B + kr * kWLd + nn));
          b[2 * q][0] = r[0];
          b[2 * q][1] = r[1];
          b[2 * q + 1][0] = r[2];
          b[2 * q + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    } else {
      // tf32 fragments by scalar loads: (k t, m g) at word t * kWLd + g,
      // bank 8t + g, no conflicts. The stage's products are summed in a
      // partial of their own and added to acc once a stage (conv_mma.cuh,
      // Ring::kFlush: the tensor cores' truncating adds would drift over
      // the thousands of mma steps of a row chunk)
      const float* Af = reinterpret_cast<const float*>(A);
      const float* Bf = reinterpret_cast<const float*>(B);
      float part[4][4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[mi][ni][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kWRows / 8; ++kk) {
        const float* ar = Af + (8 * kk + t) * kWLd;
        const float* br = Bf + (8 * kk + t) * kWLd;
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int nn = 32 * wn + 8 * ni + g;
          mma::split_tf32(__float_as_uint(br[nn]), bb[ni][0], bs[ni][0]);
          mma::split_tf32(__float_as_uint(br[4 * kWLd + nn]), bb[ni][1], bs[ni][1]);
        }
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int m = 64 * wm + 16 * mi + g;
          const float v[4] = {ar[m], ar[m + 8], ar[4 * kWLd + m], ar[4 * kWLd + m + 8]};
#pragma unroll
          for (int e = 0; e < 4; ++e) mma::split_tf32(__float_as_uint(v[e]), ab[mi][e], as[mi][e]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_tf32(part[mi][ni], as[mi], bb[ni][0], bb[ni][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_tf32(part[mi][ni], ab[mi], bs[ni][0], bs[ni][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_tf32(part[mi][ni], ab[mi], bb[ni][0], bb[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] += part[mi][ni][j];
    }
  }

  float* out = dw_part + (static_cast<size_t>(tap) * chunks + chunk) * Cin * Cout;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = a0 + 64 * wm + 16 * mi + g + 8 * hh;
        const int nn = b0 + 32 * wn + 8 * ni + 2 * t;
        store2(out + static_cast<size_t>(m) * Cout + nn, acc[mi][ni][2 * hh],
                     acc[mi][ni][2 * hh + 1]);
      }
}

}  // namespace conv
}  // namespace svdd
