// The tap routine of the implicit-GEMM 1-D convolutions on the tensor
// cores, shared by B7's dgrad (conv1d_bwd.cu), B14 (fused_conv.cu) and,
// at one tap of offset 0 on a ring of its own (Ring1), B8's two row
// products (attn_pool_bwd.cu):
//   acc[rows x 128] = sum over live taps u of src[row + off_u] . B_u,
// rows the flattened (n, i) of an (N, L, K) tensor, a source row outside
// its own sequence counting as zero (SAME padding), B_u the (K x 128)
// column tile of tap u's weight, stored by rows of n ([tap][n][k], k
// contiguous). bf16 runs mma.sync m16n8k16 with f32 accumulators; f32
// runs 3xTF32 (m16n8k8 tf32 on a big/small split of both operands,
// mma.cuh), about 2^-20 relative a product. The warp product of one
// landed stage (mma_stage) also runs the attention pool's GEMM (B3, B4:
// attn_pool.cu), whose A slab is computed from pairs of rows.
//
// Block: 8 warps over a 128 x 128 output tile, 2 along the rows by 4
// along the columns, each warp 64 x 32 (4 m16 by 4 n8 tiles).
//
// The sum runs in stages, one per (k chunk, tap group): a chunk is
// Ring<T>::kKBytes of channels (32 bytes, 16 bf16 channels, in bf16; 64
// bytes, 16 f32 channels, in f32); a group is up to kGroupMax
// consecutive live taps whose offsets span at most kSpanMax rows (the
// k = 5 convs at dilation 1 are one group). A stage holds the slab of
// source rows all the group's taps read, the tile's own 128 rows plus
// the halo (rows m0 + off_first .. m0 + 127 + off_last), and the group's
// weight tiles; every tap reads its A fragments from that one slab at
// its own row shift, so each source row is loaded once per chunk and
// not once per tap. A lane whose source row lies outside its own
// sequence (or past the last row) reads a zero row kept in shared
// memory, so the tap loop has no per-row branch and no halo needs
// filling. Stages stream through a cp.async ring; rows are padded by 16
// bytes, so the 8 row addresses of every ldmatrix phase land on distinct
// banks. With kAct (B14) a pass over the landed slab applies the eval
// BatchNorm affine, the activation and the rounding to the source's type
// once per element, between two barriers, before the taps read it (the
// halo rows are activated by both blocks that read them, 3% of the
// slab). Activating a stage ahead, beside the mmas of the stage before,
// ran no faster on an H100 (the pass's ALU work and the loop's
// instructions seem to compete for the same dispatch slots).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace svdd {
namespace conv {

constexpr int kBM = 128, kBN = 128;  // output rows and columns a block
constexpr int kThreads = 256;        // 8 warps: 2 along the rows, 4 along the columns
constexpr int kMT = 4, kNT = 4;      // m16 and n8 tiles a warp: 64 x 32
constexpr int kSpanMax = 8;          // the widest offset span of a tap group
constexpr int kGroupMax = 5;         // taps a group
constexpr int kSlabRows = kBM + kSpanMax;

// The ring of a type: kKBytes of k a stage row (32 bytes: one mma
// k-step, 16 bf16 or 8 f32 channels), kStages stages, kBlocks blocks an
// SM (what the shared memory and the registers allow), and kFlush: sum
// each stage into a partial of its own and add that to the accumulators
// once a stage, rounding to nearest. The tensor cores add into an
// accumulator by truncation, so a long chain of mmas into one
// accumulator drifts toward zero by up to 2^-23 of its value a step: over
// the 5 x 1536 f32 products of a tower conv's dgrad (3 x 960 tf32 mma
// steps) that is 3e-4 of a value near 1, past the f32 tolerance; a
// stage's partial is 30 steps long. bf16 needs no flush for its
// tolerance. f32: 64 bytes, 2 stages, one block (121 KB; the flush's
// registers); bf16: 32 bytes, 3 stages, two blocks (109 KB each).
template <int KBytes, int Stages, int Blocks, bool Flush, int GroupMax = kGroupMax>
struct RingOf {
  static constexpr int kKBytes = KBytes, kStages = Stages, kBlocks = Blocks;
  static constexpr bool kFlush = Flush;
  static constexpr int kGroupTaps = GroupMax;  // weight tiles a stage holds
  static constexpr int kKSteps = kKBytes / 32;   // mma k-steps a stage
  static constexpr int kKChunks = kKBytes / 16;  // 16-byte chunks a stage row
  static constexpr int kPitch = kKBytes + 16;    // a padded stage row
  static constexpr int kABytes = kSlabRows * kPitch;
  static constexpr int kBBytes = GroupMax * kBN * kPitch;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + kPitch;  // + the zero row
};
template <typename T>
struct Ring;
template <>
struct Ring<float> : RingOf<64, 2, 1, true> {};
template <>
struct Ring<__nv_bfloat16> : RingOf<32, 3, 2, false> {};
// The ring of a plan of one tap (B8's products, plain GEMMs): a stage
// holds one weight tile, not kGroupMax, so its k chunk can be wider: one
// tap's stage of 64 bytes has a fifth of the mma work of a five-tap
// stage between two barriers, and the loop's barriers, waits and f32
// flushes took the time (scripts/probe_attn_pool_bwd.py). f32: 256 bytes
// of k (64 channels, 8 mma k-steps), 3 stages (215 KB), one block; bf16:
// 128 bytes (64 channels), 3 stages, two blocks (114 KB each).
template <typename T>
struct Ring1;
template <>
struct Ring1<float> : RingOf<256, 3, 1, true, 1> {};
template <>
struct Ring1<__nv_bfloat16> : RingOf<128, 3, 2, false, 1> {};

// The live taps' source offsets (ascending) and their groups, passed by
// value as a kernel argument.
struct Plan {
  int off[kMaxTaps];
  int first[kMaxTaps];  // each group's first tap
  int count[kMaxTaps];  // and its number of taps
  int groups;
};

// Consecutive taps joined while the group has at most group_max taps
// (the weight tiles a stage of the plan's ring holds, R::kGroupTaps) and
// an offset span of at most kSpanMax. Returns false unless 1 <= k_live
// <= kMaxTaps, 1 <= group_max <= kGroupMax and the offsets ascend.
inline bool make_plan(const int* offs, int k_live, int group_max, Plan* p) {
  if (k_live < 1 || k_live > kMaxTaps || group_max < 1 || group_max > kGroupMax)
    return false;
  *p = Plan{};
  for (int i = 0; i < k_live; ++i) {
    if (i && offs[i] <= offs[i - 1]) return false;
    p->off[i] = offs[i];
  }
  int g = 0;
  for (int i = 0; i < k_live; ++g) {
    int j = i;
    while (j + 1 < k_live && j + 1 - i < group_max && offs[j + 1] - offs[i] <= kSpanMax)
      ++j;
    p->first[g] = i;
    p->count[g] = j - i + 1;
    i = j + 1;
  }
  p->groups = g;
  return true;
}

// Stage s into its ring slot: the slab rows of its group (zero-filled
// outside [0, NL)) and the group's weight tiles, kKBytes of k each.
// src is (NL, K), w (k_live, N, K), both in T; the plan is made for R
// (make_plan with R::kGroupTaps), so a stage holds its largest group.
template <typename T, typename R>
__device__ __forceinline__ void load_stage(const T* __restrict__ src,
                                           const T* __restrict__ w,
                                           const Plan& p, int s, long long NL,
                                           int K, int N, long long m0, int n0,
                                           uint32_t ring) {
  constexpr int kE = 16 / sizeof(T);           // elements a 16-byte chunk
  constexpr int kKE = R::kKBytes / sizeof(T);  // k elements a stage
  const int c = s / p.groups, g = s - c * p.groups;
  const int first = p.first[g], cnt = p.count[g];
  const long long lo = m0 + p.off[first];
  const int rows = kBM + p.off[first + cnt - 1] - p.off[first];
  const uint32_t st = ring + (s % R::kStages) * R::kStageBytes;
  const int k0 = c * kKE;
  for (int e = threadIdx.x; e < rows * R::kKChunks; e += kThreads) {
    const int q = e / R::kKChunks, h = e % R::kKChunks;
    const long long r = lo + q;
    const bool in = r >= 0 && r < NL;
    mma::cp_async16(st + q * R::kPitch + h * 16, in ? src + r * K + k0 + h * kE : src, in);
  }
  const T* wg = w + (static_cast<size_t>(first) * N + n0) * K + k0;
  for (int e = threadIdx.x; e < cnt * kBN * R::kKChunks; e += kThreads) {
    const int n = e / R::kKChunks, h = e % R::kKChunks;  // row n of B: tap n / kBN
    const int u = n / kBN;
    mma::cp_async16(st + R::kABytes + n * R::kPitch + h * 16,
                    wg + (static_cast<size_t>(u) * N + n - u * kBN) * K + h * kE, true);
  }
}

// The slab of a landed stage, `rows` rows of k elements k0.., in place:
// T(act(v * scale[k] + shift[k])), the product and the sum rounded
// apart as the plain version computes them.
template <typename T, typename R>
__device__ __forceinline__ void activate_slab(unsigned char* slab, int rows, int k0,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ shift,
                                              int act) {
  constexpr int kE = 16 / sizeof(T);
  for (int e = threadIdx.x; e < rows * R::kKChunks; e += kThreads) {
    const int q = e / R::kKChunks, h = e % R::kKChunks;
    uint4* at = reinterpret_cast<uint4*>(slab + q * R::kPitch + h * 16);
    uint4 u = *at;
    T* v = reinterpret_cast<T*>(&u);
    const int k = k0 + h * kE;  // a multiple of 4: whole float4s
    float sc[kE], sh[kE];
#pragma unroll
    for (int j = 0; j < kE; j += 4) {
      *reinterpret_cast<float4*>(sc + j) = *reinterpret_cast<const float4*>(scale + k + j);
      *reinterpret_cast<float4*>(sh + j) = *reinterpret_cast<const float4*>(shift + k + j);
    }
#pragma unroll
    for (int j = 0; j < kE; ++j)
      v[j] = from_f<T>(activate(act, __fadd_rn(__fmul_rn(to_f(v[j]), sc[j]), sh[j])));
    *at = u;
  }
}

// sum += A . B over one landed stage of KSteps mma k-steps (32 bytes of k
// each): a_row[mi], this lane's ldmatrix row address in the A slab for
// m16 tile mi, its 16-byte chunk included; b_row, its row of the (n, k)
// B tile, chunk included; Pitch, the B tile's row pitch in bytes. bf16
// m16n8k16; f32 3xTF32. The tap routine below and the attention pool
// (attn_pool.cu) run their products here.
template <typename T, int KSteps, int Pitch>
__device__ __forceinline__ void mma_stage(const uint32_t (&a_row)[kMT], uint32_t b_row,
                                          float (&sum)[kMT][kNT][4]) {
  constexpr bool kBf16 = sizeof(T) == 2;
#pragma unroll
  for (int kk = 0; kk < KSteps; ++kk) {
    uint32_t b[kNT][2];
#pragma unroll
    for (int q = 0; q < kNT / 2; ++q) {
      uint32_t r[4];
      mma::ldsm_x4(r, b_row + 16 * q * Pitch + kk * 32);
      b[2 * q][0] = r[0];
      b[2 * q][1] = r[1];
      b[2 * q + 1][0] = r[2];
      b[2 * q + 1][1] = r[3];
    }
    uint32_t bb[kNT][2], bs[kNT][2];  // f32: b's tf32 big and small parts
    if constexpr (!kBf16) {
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma::split_tf32(b[ni][j], bb[ni][j], bs[ni][j]);
    }
    // the A fragments of all four m16 tiles, then the mmas (in f32
    // each 3xTF32 term over every tile before the next), so no mma
    // waits on the one before it
    uint32_t a[kMT][4], as[kMT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      mma::ldsm_x4(a[mi], a_row[mi] + kk * 32);
      if constexpr (!kBf16) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma::split_tf32(a[mi][j], a[mi][j], as[mi][j]);
      }
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          mma::mma_bf16(sum[mi][ni], a[mi], b[ni][0], b[ni][1]);
    } else {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          mma::mma_tf32(sum[mi][ni], as[mi], bb[ni][0], bb[ni][1]);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          mma::mma_tf32(sum[mi][ni], a[mi], bs[ni][0], bs[ni][1]);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
          mma::mma_tf32(sum[mi][ni], a[mi], bb[ni][0], bb[ni][1]);
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&t)[kMT][kNT][4]) {
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) t[mi][ni][j] = 0.f;
}

// acc += part, rounding to nearest: the flush of a stage's partial sum
__device__ __forceinline__ void add_tile(float (&acc)[kMT][kNT][4],
                                         const float (&part)[kMT][kNT][4]) {
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] += part[mi][ni][j];
}

// acc = the tap sum of the block's tile, rows m0.. (of NL) by columns
// n0.. (of N), over K = the source's channels. With kAct the source is
// activated per stage (scale, shift (K,) f32 and an ACT code). R is the
// ring (Ring<T>, or Ring1<T> for a plan of one tap); the block's dynamic
// shared memory is R::kSmemBytes.
template <typename T, bool kAct, typename R = Ring<T>>
__device__ __forceinline__ void tap_gemm(const T* __restrict__ src,
                                         const T* __restrict__ w, const Plan& p,
                                         long long NL, int L, int K, int N,
                                         long long m0, int n0,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift, int act,
                                         unsigned char* smem,
                                         float (&acc)[kMT][kNT][4]) {
  constexpr int kKE = R::kKBytes / sizeof(T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const uint32_t ring = mma::smem_u32(smem);
  const uint32_t zero = ring + R::kStages * R::kStageBytes;
  if (tid < R::kPitch / 4)  // published by the loop's first barrier
    reinterpret_cast<uint32_t*>(smem + R::kStages * R::kStageBytes)[tid] = 0u;
  // the mmas' accumulators: a stage's own partial where R::kFlush, else acc
  float part[kMT][kNT][4];
  float (&sum)[kMT][kNT][4] = *(R::kFlush ? &part : &acc);
  zero_tile(acc);

  const int n_stages = (K / kKE) * p.groups;
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < n_stages) load_stage<T, R>(src, w, p, s, NL, K, N, m0, n0, ring);
    mma::cp_async_commit();
  }
  // ldmatrix rows of this lane: A, row ra of each m16 tile at 16-byte
  // chunk ac; B, weight row bn (+ 16 per pair of n8 tiles) at chunk bc
  const int ra = ((lane >> 3) & 1) * 8 + (lane & 7), ac = lane >> 4;
  const int bn = 32 * wn + (lane >> 4) * 8 + (lane & 7), bc = (lane >> 3) & 1;
  // the position in its sequence of this lane's A row of each m16 tile
  int pos[kMT];
  bool rin[kMT];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    const long long row = m0 + 64 * wm + 16 * mi + ra;
    rin[mi] = row < NL;
    pos[mi] = rin[mi] ? static_cast<int>(row % L) : 0;
  }

#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    mma::cp_async_wait<R::kStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1 consumed by every warp
    if (s + R::kStages - 1 < n_stages)
      load_stage<T, R>(src, w, p, s + R::kStages - 1, NL, K, N, m0, n0, ring);
    mma::cp_async_commit();
    const int c = s / p.groups, g = s - c * p.groups;
    const int first = p.first[g], cnt = p.count[g];
    const int off0 = p.off[first];
    const uint32_t st = ring + (s % R::kStages) * R::kStageBytes;
    if constexpr (kAct) {
      activate_slab<T, R>(smem + (s % R::kStages) * R::kStageBytes,
                       kBM + p.off[first + cnt - 1] - off0, c * kKE, scale, shift, act);
      __syncthreads();
    }
    if constexpr (R::kFlush) zero_tile(part);
#pragma unroll 1
    for (int u = 0; u < cnt; ++u) {
      const int off = p.off[first + u];
      uint32_t a_row[kMT];  // this lane's A row in each m16 tile, or the zero row
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int sp = pos[mi] + off;
        const bool v = rin[mi] && sp >= 0 && sp < L;
        a_row[mi] = (v ? st + (64 * wm + 16 * mi + ra + off - off0) * R::kPitch : zero) +
                    ac * 16;
      }
      mma_stage<T, R::kKSteps, R::kPitch>(
          a_row, st + R::kABytes + (u * kBN + bn) * R::kPitch + bc * 16, sum);
    }
    if constexpr (R::kFlush) add_tile(acc, part);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// f(row, col, a, b) for every pair of adjacent columns (col, col + 1) of
// the tile's rows below NL, a and b their accumulators: tap_gemm's
// accumulator layout, for the epilogues
template <typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[kMT][kNT][4],
                                              long long m0, int n0, long long NL,
                                              F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + 64 * wm + 16 * mi + g + 8 * h;
      if (row >= NL) continue;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
        f(row, n0 + 32 * wn + 8 * ni + 2 * t, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

// out[row][col] = T(v(acc, col)) for the tile's rows below NL; out is
// (NL, N), two adjacent columns a store.
template <typename T, typename F>
__device__ __forceinline__ void store_tile(const float (&acc)[kMT][kNT][4],
                                           long long m0, int n0, long long NL,
                                           int N, T* __restrict__ out, F v) {
  for_each_pair(acc, m0, n0, NL, [&](long long row, int col, float a, float b) {
    store2(out + row * N + col, v(a, col), v(b, col + 1));
  });
}

// Blocks of a launch over (NL, N): row tiles by column tiles, the column
// tile fastest, so the blocks that share a slab run together.
inline long long grid_blocks(long long NL, int N) {
  return (NL + kBM - 1) / kBM * (N / kBN);
}

__device__ __forceinline__ void tile_origin(int N, long long* m0, int* n0) {
  const int col_tiles = N / kBN;
  *m0 = static_cast<long long>(blockIdx.x / col_tiles) * kBM;
  *n0 = (blockIdx.x % col_tiles) * kBN;
}

}  // namespace conv
}  // namespace svdd
