// Pieces of the CNN denoiser layer shared by its forward (B1,
// cnn_layer.cu) and its backward (B6, cnn_layer_bwd.cu). The backward
// rebuilds the relu mask by running exactly this code, with the same
// block shape and tap order, on the same inputs, so the recomputed conv
// output, and hence the mask, is the forward's bit for bit, in bf16 too.
// Its dgrad pass runs the same tap routine on the masked cotangent with
// the flipped tap stack.
//
// The tap products are an implicit-GEMM convolution on the tensor cores:
// for each live tap t, acc[rows x 128] += h[rows + off_t] . W_t, with h
// resident in shared memory and W_t streamed through a ring of stages.
// bf16 runs mma.sync m16n8k16 with f32 accumulators; f32 runs 3xTF32
// (m16n8k8 tf32 on a big/small split of both operands, mma.cuh).
//
// Block geometry: one block of 12 warps per (sequence, pass of up to
// 240 output rows). A pass is cut into m16 tiles (13 at L = 200: 208
// rows for 200), split among three row groups of warps (5, 4 and 4
// tiles at L = 200); four column groups of warps each own 32 of the 128
// output columns. So a warp holds up to 5 x 4 m16n8 accumulator tiles,
// each A fragment read from shared memory feeds 4 mmas and each B
// fragment up to 5. (Two row groups of 7 tiles, and four of 4, ran
// slower in f32 in probes on an H100.) An m16 tile whose shifted source rows all lie outside the
// rows the pass reads is skipped for that tap (most of the work of the
// outer taps at dilation 64); a row whose source lies outside reads a
// zero row kept in shared memory, so the loop has no per-row branch.
//
// Shared memory of a block (smem_bytes): the weight ring, then the
// sequence's rows in T, 16-byte padded (so the 8 row addresses of every
// ldmatrix phase land on distinct banks), then the zero row. A ring
// stage holds 64 bytes of k of each of the 128 weight rows (an 8 KB
// stage: 16 f32 or 32 bf16 input channels), its 16-byte chunks
// XOR-swizzled by row (chunk c of row n at c ^ ((n >> 1) & 3)), again
// free of bank conflicts. The wrappers' kernel_takes
// (ops/cnn_layer.py) computes the same plan.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace svdd {
namespace cnn {

constexpr int kC = 128;                  // channels (the denoiser's hidden size)
constexpr int kColGroups = 4;            // warps across the output columns
constexpr int kRowGroups = 3;            // warps across a pass's m16 tiles
constexpr int kWarps = kColGroups * kRowGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kC / kColGroups / 8; // n8 tiles a warp: 32 columns
constexpr int kMaxM = 5;                 // m16 tiles a warp at most
constexpr int kPassRows = 16 * kMaxM * kRowGroups;  // 240 output rows a block
constexpr int kSmemMax = 232448;         // dynamic shared memory of a block
constexpr int kLnRows = 4;               // rows a warp normalises at once

// The weight ring: stages, and the bytes of each of the 128 weight rows
// a stage holds (f32: two stages of 16 input channels, 8 KB each; a
// larger ring would shorten the longest f32 sequence below 400 rows;
// bf16: three of 64 channels, 16 KB each, so four mma k-steps a
// barrier); and kGroup, the m16 tiles whose A fragments a warp loads
// before their mmas. Two or four stages, and other groups, ran slower in
// probes on an H100.
template <typename T>
struct Ring;
template <>
struct Ring<float> {
  static constexpr int kStages = 2, kStageRow = 64, kGroup = 1;
  static constexpr int kStageBytes = kC * kStageRow;
};
template <>
struct Ring<__nv_bfloat16> {
  static constexpr int kStages = 3, kStageRow = 128, kGroup = 4;
  static constexpr int kStageBytes = kC * kStageRow;
};

// The swizzled byte offset of 16-byte chunk c of weight row n in a ring
// stage: the 8 rows of an ldmatrix phase land on 8 distinct bank groups.
template <int kStageRow>
__device__ __forceinline__ uint32_t stage_at(int n, int c) {
  const int phys = kStageRow == 128 ? c ^ (n & 7) : c ^ ((n >> 1) & 3);
  return n * kStageRow + (phys << 4);
}

template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return kC * sizeof(T) + 16;
}
template <typename T>
__host__ __device__ constexpr int ld() {
  return row_bytes<T>() / sizeof(T);
}

// Dynamic shared memory of a block for a sequence of l rows.
template <typename T>
inline size_t smem_bytes(int l) {
  return static_cast<size_t>(Ring<T>::kStages) * Ring<T>::kStageBytes +
         static_cast<size_t>(l + 1) * row_bytes<T>();
}

// The sequence's rows in a block's shared memory, after the ring.
template <typename T>
__device__ __forceinline__ T* seq_rows(unsigned char* smem) {
  return reinterpret_cast<T*>(smem + Ring<T>::kStages * Ring<T>::kStageBytes);
}

// A block's pass: output rows [r0, r0 + rows) (all below L) as `tiles`
// m16 tiles, and [lo, hi], the rows its live taps read.
struct Pass {
  int r0, rows, tiles, lo, hi;
};

__device__ __forceinline__ Pass make_pass(const Taps& taps, int k_live,
                                          int L) {
  Pass p;
  p.r0 = blockIdx.x * kPassRows;
  p.rows = min(kPassRows, L - p.r0);
  p.tiles = (p.rows + 15) / 16;
  p.lo = max(p.r0 + taps.off[0], 0);
  p.hi = min(p.r0 + p.rows - 1 + taps.off[k_live - 1], L - 1);
  return p;
}

// This warp's m16 tiles: [*begin, *begin + *count) of the pass's, the
// pass's tiles split between the row groups as evenly as they go
__device__ __forceinline__ void warp_tiles(const Pass& p, int* begin,
                                           int* count) {
  const int rg = (threadIdx.x >> 5) / kColGroups;
  const int base = p.tiles / kRowGroups, rem = p.tiles % kRowGroups;
  *begin = rg * base + min(rg, rem);
  *count = base + (rg < rem);
}

// LayerNorm statistics of kLnRows rows of xn (row pitch `pitch`), one
// warp, 4 channels a lane, the rows' loads and shuffles in flight
// together: rows r0 + kWarps q (q < kLnRows; a row past `last` reads row r0,
// its results unused), v[q][j] = T(x + bias_row) at channel lane + 32j,
// and each row's mean and 1/std in f32, summed in the same order for
// every row.
template <typename T>
__device__ __forceinline__ void ln_rows(const T* xn, int pitch, int r0,
                                        int last, const float* br, int lane,
                                        float eps, float (&v)[kLnRows][4],
                                        float (&mu)[kLnRows],
                                        float (&rstd)[kLnRows]) {
  float s[kLnRows], q[kLnRows];
#pragma unroll
  for (int k = 0; k < kLnRows; ++k) {
    const T* xr = xn + (r0 + kWarps * k <= last ? r0 + kWarps * k : r0) * pitch;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[k][j] = round_to<T>(to_f(xr[lane + 32 * j]) + br[j]);
  }
#pragma unroll
  for (int k = 0; k < kLnRows; ++k) s[k] = ((v[k][0] + v[k][1]) + v[k][2]) + v[k][3];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < kLnRows; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
#pragma unroll
  for (int k = 0; k < kLnRows; ++k) {
    mu[k] = s[k] * (1.f / kC);
    q[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) q[k] += (v[k][j] - mu[k]) * (v[k][j] - mu[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < kLnRows; ++k) q[k] += __shfl_xor_sync(0xffffffffu, q[k], o);
#pragma unroll
  for (int k = 0; k < kLnRows; ++k) rstd[k] = rsqrtf(q[k] * (1.f / kC) + eps);
}

// Row L of hs (the zero row the out-of-range sources read) set to 0.
template <typename T>
__device__ __forceinline__ void zero_row(T* hs, int L) {
  for (int e = threadIdx.x; e < kC; e += kThreads)
    hs[L * ld<T>() + e] = from_f<T>(0.f);
}

// hs[r] = T(T(T(LN(x + bias_row)) * T(g)) + T(b)) for rows lo..hi: the
// conv input, rounded where cnn_layer_reference rounds; and the zero row.
// The x rows come in by cp.async, all at once, and are normalised in
// place, so no warp waits on device memory row by row.
template <typename T>
__device__ __forceinline__ void ln_prologue(const T* __restrict__ xn,
                                            const T* __restrict__ bias_row_n,
                                            const float* __restrict__ ln_g,
                                            const float* __restrict__ ln_b,
                                            float eps, int lo, int hi, int L,
                                            T* hs) {
  constexpr int kE = 16 / sizeof(T), kChunks = kC / kE;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t hs_u = mma::smem_u32(hs);
  for (int e = tid; e < (hi - lo + 1) * kChunks; e += kThreads) {
    const int r = lo + e / kChunks, c = e % kChunks;
    mma::cp_async16(hs_u + r * row_bytes<T>() + c * 16, xn + r * kC + c * kE, true);
  }
  mma::cp_async_commit();
  zero_row<T>(hs, L);
  float br[4], g[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = lane + 32 * j;
    br[j] = to_f(bias_row_n[ch]);
    g[j] = round_to<T>(ln_g[ch]);
    b[j] = round_to<T>(ln_b[ch]);
  }
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int r0 = lo + warp; r0 <= hi; r0 += kLnRows * kWarps) {
    float v[kLnRows][4], mu[kLnRows], rstd[kLnRows];
    ln_rows<T>(hs, ld<T>(), r0, hi, br, lane, eps, v, mu, rstd);
#pragma unroll
    for (int k = 0; k < kLnRows; ++k) {
      const int r = r0 + kWarps * k;
      if (r > hi) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float hn = round_to<T>((v[k][j] - mu[k]) * rstd[k]);
        hs[r * ld<T>() + lane + 32 * j] = from_f<T>(round_to<T>(hn * g[j]) + b[j]);
      }
    }
  }
}

// Stages 0 .. kStages - 2 of the weight ring in flight: called before
// the prologue that fills hs, so their loads overlap it. wt is
// (k_live, kC, kC) in T, each tap stored transposed, [t][out][in] (the B
// operand by rows of n); stage s holds bytes [s % per_tap * kStageRow,
// ...) of every row of tap s / per_tap.
template <typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ wt, int s,
                                           unsigned char* ring) {
  using R = Ring<T>;
  constexpr int kWRowB = kC * sizeof(T);          // a weight row in device memory
  constexpr int kPerTap = kWRowB / R::kStageRow;  // stages a tap
  constexpr int kChunks = R::kStageRow / 16;
  const int t = s / kPerTap, kc = s - t * kPerTap;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(wt + static_cast<size_t>(t) * kC * kC) +
      kc * R::kStageRow;
  const uint32_t dst = mma::smem_u32(ring) + (s % R::kStages) * R::kStageBytes;
  for (int i = threadIdx.x; i < kC * kChunks; i += kThreads) {
    const int n = i / kChunks, c = i % kChunks;
    mma::cp_async16(dst + stage_at<R::kStageRow>(n, c), src + n * kWRowB + c * 16, true);
  }
}

template <typename T>
__device__ __forceinline__ void prefetch_weights(const T* __restrict__ wt,
                                                 int k_live,
                                                 unsigned char* ring) {
  constexpr int kPerTap = kC * sizeof(T) / Ring<T>::kStageRow;
  for (int s = 0; s < Ring<T>::kStages - 1; ++s) {
    if (s < k_live * kPerTap) load_stage<T>(wt, s, ring);
    mma::cp_async_commit();
  }
}

// acc[mi][ni] = sum over live taps t of (hs[row + off_t] @ W_t) for the
// m16n8 tile (mi, ni) of this warp: rows p.r0 + 16 (begin + mi) + 0..15
// (warp_tiles), columns 32 cg + 8 ni + 0..7; a source row outside
// [p.lo, p.hi] counts as zero. The caller has called prefetch_weights
// and written hs rows lo..hi and the zero row; the first barrier here
// orders those writes. The ring is free again once every warp is past
// the loop (the caller's next __syncthreads).
template <typename T>
__device__ __forceinline__ void tap_products(const T* hs,
                                             const T* __restrict__ wt,
                                             const Taps& taps, int k_live,
                                             int L, const Pass& p,
                                             unsigned char* ring,
                                             float (&acc)[kMaxM][kNT][4]) {
  using R = Ring<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kGroup = R::kGroup;
  constexpr int kStages = R::kStages;
  constexpr int kRowB = row_bytes<T>();
  constexpr int kPerTap = kC * sizeof(T) / R::kStageRow;  // stages a tap: 8 f32, 2 bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = warp % kColGroups;
  int m0, mc;
  warp_tiles(p, &m0, &mc);
#pragma unroll
  for (int mi = 0; mi < kMaxM; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int n_stages = k_live * kPerTap;
  const uint32_t ring_u = mma::smem_u32(ring);
  const uint32_t hs_u = mma::smem_u32(hs);
  // ldmatrix rows of this lane: B, weight row bn (+ 16 per tile pair) at
  // chunk parity bc; A, row ra of an m16 tile at 16-byte chunk ac
  const int bn = 32 * cg + (lane >> 4) * 8 + (lane & 7);
  const int bc = (lane >> 3) & 1;
  const int ra = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int ac = lane >> 4;

#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1 consumed by every warp
    if (s + kStages - 1 < n_stages) load_stage<T>(wt, s + kStages - 1, ring);
    mma::cp_async_commit();
    const int t = s / kPerTap, kc = s - t * kPerTap;
    const int off = taps.off[t];
    const uint32_t st = ring_u + (s % kStages) * R::kStageBytes;
    // this lane's A row address in each m16 tile (the zero row where its
    // source is outside [lo, hi]), and whether the tile reads any row
    uint32_t a_row[kMaxM];
    bool live[kMaxM];
#pragma unroll
    for (int mi = 0; mi < kMaxM; ++mi) {
      const int tr = p.r0 + 16 * (m0 + mi) + off;
      live[mi] = mi < mc && tr + 15 >= p.lo && tr <= p.hi;
      const int src = tr + ra;
      const int row = (src >= p.lo && src <= p.hi) ? src : L;
      a_row[mi] = hs_u + row * kRowB + kc * R::kStageRow + ac * 16;
    }
#pragma unroll
    for (int kk = 0; kk < R::kStageRow / 32; ++kk) {  // 32-byte mma k-steps
      uint32_t b[kNT][2], bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int q = 0; q < kNT / 2; ++q) {
        const int n = bn + 16 * q, c = 2 * kk + bc;
        uint32_t r[4];
        mma::ldsm_x4(r, st + stage_at<R::kStageRow>(n, c));
        b[2 * q][0] = r[0];
        b[2 * q][1] = r[1];
        b[2 * q + 1][0] = r[2];
        b[2 * q + 1][1] = r[3];
      }
      if constexpr (!kBf16) {
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma::split_tf32(b[ni][j], bb[ni][j], bs[ni][j]);
      }
      // kGroup m16 tiles at a time: their A fragments first, then the
      // mmas (in f32 each 3xTF32 term over the group's tiles before the
      // next term), so no mma waits on the one just issued
#pragma unroll
      for (int m0g = 0; m0g < kMaxM; m0g += kGroup) {
        uint32_t ab[kGroup][4], as[kGroup][4];
        bool lv[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int mi = m0g + u < kMaxM ? m0g + u : kMaxM - 1;
          lv[u] = m0g + u < kMaxM && live[mi];
          if (!lv[u]) continue;
          mma::ldsm_x4(ab[u], a_row[mi] + kk * 32);
          if constexpr (!kBf16) {
#pragma unroll
            for (int j = 0; j < 4; ++j) mma::split_tf32(ab[u][j], ab[u][j], as[u][j]);
          }
        }
        if constexpr (kBf16) {
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int mi = m0g + u < kMaxM ? m0g + u : kMaxM - 1;
            if (!lv[u]) continue;
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni)
              mma::mma_bf16(acc[mi][ni], ab[u], b[ni][0], b[ni][1]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int mi = m0g + u < kMaxM ? m0g + u : kMaxM - 1;
            if (!lv[u]) continue;
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni)
              mma::mma_tf32(acc[mi][ni], as[u], bb[ni][0], bb[ni][1]);
          }
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int mi = m0g + u < kMaxM ? m0g + u : kMaxM - 1;
            if (!lv[u]) continue;
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni)
              mma::mma_tf32(acc[mi][ni], ab[u], bs[ni][0], bs[ni][1]);
          }
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int mi = m0g + u < kMaxM ? m0g + u : kMaxM - 1;
            if (!lv[u]) continue;
#pragma unroll
            for (int ni = 0; ni < kNT; ++ni)
              mma::mma_tf32(acc[mi][ni], ab[u], bb[ni][0], bb[ni][1]);
          }
        }
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

// Two adjacent values (an accumulator pair's columns) as f32.
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Writes v(acc, row, col) for the pass's rows (below L) into hs, two
// adjacent columns a store: the accumulators' values staged for a
// coalesced pass over whole rows. The caller's __syncthreads before this
// frees hs (every warp past the tap loop) and one after it publishes it.
template <typename T, typename F>
__device__ __forceinline__ void stage_rows(const Pass& p, int L,
                                           const float (&acc)[kMaxM][kNT][4],
                                           T* hs, F v) {
  const int lane = threadIdx.x & 31;
  const int cg = (threadIdx.x >> 5) % kColGroups;
  const int g = lane >> 2, t = lane & 3;
  int m0, mc;
  warp_tiles(p, &m0, &mc);
#pragma unroll
  for (int mi = 0; mi < kMaxM; ++mi) {
    if (mi >= mc) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p.r0 + 16 * (m0 + mi) + g + 8 * h;
      if (row >= L) continue;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int col = 32 * cg + 8 * ni + 2 * t;
        store2(hs + row * ld<T>() + col, v(acc[mi][ni][2 * h], col),
               v(acc[mi][ni][2 * h + 1], col + 1));
      }
    }
  }
}

// 16 bytes of kE values of T, as f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) f[j] = to_f(e[j]);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&f)[16 / sizeof(T)]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) e[j] = from_f<T>(f[j]);
  return u;
}

// out[col] = the sum over the pass's rows of a column, given s[j], this
// thread's sum over the rows of its coalesced passes (thread tid takes
// 16-byte chunk tid % (kC / kE) of every row it visits) of column
// (tid % (kC / kE)) * kE + j; summed in a fixed order. red: kThreads * kE
// floats of shared memory, free at the call.
template <int kE>
__device__ __forceinline__ void chunk_column_sums(const float (&s)[kE],
                                                  float* red,
                                                  float* __restrict__ out) {
  constexpr int kChunks = kC / kE, kVisits = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0, "a thread keeps one chunk");
  __syncthreads();  // red free
#pragma unroll
  for (int j = 0; j < kE; ++j) red[threadIdx.x * kE + j] = s[j];
  __syncthreads();
  if (threadIdx.x < kC) {
    const int c = threadIdx.x / kE, j = threadIdx.x % kE;
    float t = 0.f;
    for (int q = 0; q < kVisits; ++q) t += red[(q * kChunks + c) * kE + j];
    out[threadIdx.x] = t;
  }
}

// out[c] = the sum over the block's rows of a per-column value, given
// s[ni][e], this lane's sum over its rows of column 32 cg + 8 ni + 2 t
// + e; summed in a fixed order (the 8 lanes of a column, then the row
// groups in turn), so a run repeats bit for bit. red: kRowGroups * kC
// floats of shared memory, free at the call.
__device__ __forceinline__ void column_sums(float (&s)[kNT][2], float* red,
                                            float* __restrict__ out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = warp % kColGroups, rg = warp / kColGroups;
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        s[ni][e] += __shfl_xor_sync(0xffffffffu, s[ni][e], o);
  __syncthreads();  // red free
  if (lane < 4) {
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[rg * kC + 32 * cg + 8 * ni + 2 * lane + e] = s[ni][e];
  }
  __syncthreads();
  if (tid < kC) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) t += red[g * kC + tid];
    out[tid] = t;
  }
}

}  // namespace cnn
}  // namespace svdd
