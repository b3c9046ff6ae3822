// Backward of the fused CNN denoiser layer (B1):
//   out = relu(y) + x,  y = conv_k_dil(h) + conv_bias,
//   h = LN(x + bias_row) * g + b
// given the output cotangent ct, returns dx, d bias_row, d kernel (live
// taps), d ln_scale, d ln_bias and d conv_bias.
//
// Replaces svdd_tpu/ops/cnn_layer_pallas.py:cnn_layer_bwd_pallas
// (pallas_call at :504, body _bwd_kernel :266). Same math:
//   dacc = ct where y > 0, else 0;          d conv_bias = sum dacc
//   dhs[j] = sum_t dacc[j - off_t] @ W_t^T  (the mirrored tap sum)
//   dW_t = h^T @ shift(dacc, -off_t)        (summed over every row)
//   d ln_scale = sum dhs * hn, d ln_bias = sum dhs, dhn = dhs * g,
//   dh0 = rstd * (dhn - mean_c(dhn) - hn * mean_c(dhn * hn)),
//   dx = T(dh0) + ct, d bias_row = sum over L of dh0,
// with hn the f32 normalised row, dacc rounded to the activation type
// (exact: ct is already of that type) before the dgrad and wgrad
// products, and every product summed in f32. With ref_round (sequences
// below L = 100, where JAX differentiates cnn_layer_reference rather
// than taking the Pallas backward; ops/cnn_layer.bwd_rounds_as_reference)
// the dgrad pass rounds as that VJP's bf16 ops do: dhs, dhs * T(g),
// dhs * T(hn) and dh0 each to T before they are used or summed (the
// wrapper rounds the sums); in f32 every such rounding is exact.
//
// What bounds it on an H100: three tap-product passes of the forward's
// size (recompute, dgrad, wgrad), each 2 C^2 per (row, live tap) whose
// source lies inside the sequence, on the tensor cores: bf16 mma, or
// 3xTF32 in f32 (mma.cuh). Design, four launches on the stream:
//  1. mask: per (sequence, pass of up to 240 rows) the forward's own
//     prologue and tap routine (cnn_layer.cuh), same block shape and tap
//     order, so the recomputed y, and the relu mask, are the forward's
//     bit for bit; writes dacc and the pass's rows of h (both in T), and
//     the pass's column sums of dacc;
//  2. dgrad + LayerNorm backward: per pass, the same tap routine over the
//     dacc rows with the flipped live-tap stack (the live offsets are
//     symmetric, so tap t of the flipped stack has offset off_t and
//     weight W_{k-1-t}^T, whose transposed storage is W_{k-1-t} itself);
//     the LN backward runs in the epilogue: its row sums over 128
//     channels come from quad shuffles within a warp and a shared-memory
//     exchange across the four column groups, added in a fixed order;
//  3. wgrad: per (tap, chunk of rows) a 128 x 128 tensor-core GEMM of h
//     shifted by the tap's offset against dacc, rows streamed through a
//     cp.async ring (bf16: ldmatrix.trans fragments; f32: 3xTF32 on
//     scalar fragment loads, 8-float row padding keeping them free of
//     bank conflicts);
//  4. deterministic reduces of every per-block partial sum (reduce.cuh).
// The TPU accumulated dW and the per-channel sums over a sequential
// grid; blocks on the card run in parallel, so each writes a partial
// and a second pass sums them in a fixed order (no float atomics, so a
// run repeats bit for bit).
#include "cnn_layer.cuh"
#include "reduce.cuh"

namespace {

using svdd::cnn::kC;
using svdd::cnn::kColGroups;
using svdd::cnn::kMaxM;
using svdd::cnn::kNT;
using svdd::cnn::kPassRows;
using svdd::cnn::kThreads;
namespace mma = svdd::mma;

// 1. recompute y, mask the cotangent: dacc = T(ct if y > 0 else 0)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    cnn_bwd_mask_kernel(const T* __restrict__ x, const T* __restrict__ bias_row,
                        const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ wt,
                        const float* __restrict__ cb, const T* __restrict__ ct,
                        T* __restrict__ h_out, T* __restrict__ dacc,
                        unsigned char* __restrict__ mask_out,
                        float* __restrict__ dcb_part, svdd::Taps taps,
                        int k_live, int L, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = svdd::cnn::seq_rows<T>(smem);

  const int n = blockIdx.y;
  const size_t base = static_cast<size_t>(n) * L * kC;
  const svdd::cnn::Pass p = svdd::cnn::make_pass(taps, k_live, L);
  svdd::cnn::prefetch_weights<T>(wt, k_live, smem);
  svdd::cnn::ln_prologue<T>(x + base, bias_row + static_cast<size_t>(n) * kC,
                            ln_g, ln_b, eps, p.lo, p.hi, L, hs);
  float acc[kMaxM][kNT][4];
  svdd::cnn::tap_products<T>(hs, wt, taps, k_live, L, p, smem, acc);

  // this pass's rows of h, for the wgrad, 16 bytes a thread a step
  constexpr int kE = 16 / sizeof(T), kChunks = kC / kE;
  for (int e = threadIdx.x; e < p.rows * kChunks; e += kThreads) {
    const int r = p.r0 + e / kChunks, c = e % kChunks;
    *reinterpret_cast<uint4*>(h_out + base + static_cast<size_t>(r) * kC + c * kE) =
        *reinterpret_cast<const uint4*>(hs + r * svdd::cnn::ld<T>() + c * kE);
  }

  // y, exact in T, staged in hs once every thread has copied its h rows;
  // then dacc, the mask and the column sums of dacc over whole rows, 16
  // bytes a thread a step
  __syncthreads();
  svdd::cnn::stage_rows<T>(p, L, acc, hs, [&](float a, int col) {
    return svdd::cnn::conv_out<T>(a, cb[col]);
  });
  __syncthreads();
  float s[kE] = {};
#pragma unroll 4
  for (int e = threadIdx.x; e < p.rows * kChunks; e += kThreads) {
    const int r = p.r0 + e / kChunks, c = e % kChunks;
    const size_t at = base + static_cast<size_t>(r) * kC + c * kE;
    float y[kE], d[kE];
    svdd::cnn::unpack16<T>(*reinterpret_cast<const uint4*>(hs + r * svdd::cnn::ld<T>() + c * kE), y);
    svdd::cnn::unpack16<T>(*reinterpret_cast<const uint4*>(ct + at), d);
    uint32_t on[2] = {0u, 0u};  // the kE mask bytes
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const bool pos = y[j] > 0.f;
      on[j / 4] |= static_cast<uint32_t>(pos) << (8 * (j % 4));
      d[j] = pos ? d[j] : 0.f;
      s[j] += d[j];
    }
    *reinterpret_cast<uint4*>(dacc + at) = svdd::cnn::pack16<T>(d);
    if (mask_out) {
      if constexpr (kE == 8)
        *reinterpret_cast<uint2*>(mask_out + at) = make_uint2(on[0], on[1]);
      else
        *reinterpret_cast<uint32_t*>(mask_out + at) = on[0];
    }
  }
  const size_t blk = static_cast<size_t>(n) * gridDim.x + blockIdx.x;
  svdd::cnn::chunk_column_sums<kE>(s, reinterpret_cast<float*>(smem), dcb_part + blk * kC);
}

// 2. dhs = the mirrored tap sum over dacc, then the LayerNorm backward
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    cnn_bwd_dgrad_ln_kernel(const T* __restrict__ x,
                            const T* __restrict__ bias_row,
                            const float* __restrict__ ln_g,
                            const T* __restrict__ wflip, const T* __restrict__ ct,
                            const T* __restrict__ dacc, T* __restrict__ dx,
                            float* __restrict__ dg_part,
                            float* __restrict__ db_part,
                            float* __restrict__ dbr_part, svdd::Taps taps,
                            int k_live, int L, float eps, int ref_round) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = svdd::cnn::seq_rows<T>(smem);

  const int n = blockIdx.y;
  const size_t base = static_cast<size_t>(n) * L * kC;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const svdd::cnn::Pass p = svdd::cnn::make_pass(taps, k_live, L);
  svdd::cnn::prefetch_weights<T>(wflip, k_live, smem);
  // the dacc rows the taps read, and the zero row
  constexpr int kE = 16 / sizeof(T), kChunks = kC / kE;
  for (int e = tid; e < (p.hi - p.lo + 1) * kChunks; e += kThreads) {
    const int r = p.lo + e / kChunks, c = e % kChunks;
    mma::cp_async16(mma::smem_u32(hs + r * svdd::cnn::ld<T>() + c * kE),
                    dacc + base + static_cast<size_t>(r) * kC + c * kE, true);
  }
  mma::cp_async_commit();
  svdd::cnn::zero_row<T>(hs, L);
  mma::cp_async_wait<0>();  // the tap loop's first barrier publishes them

  float acc[kMaxM][kNT][4];
  svdd::cnn::tap_products<T>(hs, wflip, taps, k_live, L, p, smem, acc);
  __syncthreads();  // the ring is free: every warp is past the tap loop

  // scratch in the ring: LN statistics of the pass's rows, the row sums
  // of each column group, the column-sum exchange
  float* mu_s = reinterpret_cast<float*>(smem);
  float* rstd_s = mu_s + kPassRows;
  float* ex = rstd_s + kPassRows;              // [kPassRows][kColGroups][2]
  float* red = ex + kPassRows * kColGroups * 2;
  static_assert(((2 + 2 * kColGroups) * kPassRows + svdd::cnn::kRowGroups * kC) * 4 <=
                    svdd::cnn::Ring<float>::kStages * svdd::cnn::Ring<float>::kStageBytes,
                "scratch fits the ring");

  // LN statistics of the pass's rows, as the forward computes them
  const T* brn = bias_row + static_cast<size_t>(n) * kC;
  float br[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) br[j] = svdd::to_f(brn[lane + 32 * j]);
  constexpr int kLn = svdd::cnn::kLnRows;
  for (int r0 = warp; r0 < p.rows; r0 += kLn * svdd::cnn::kWarps) {
    float v[kLn][4], mu[kLn], rstd[kLn];
    svdd::cnn::ln_rows<T>(x + base + static_cast<size_t>(p.r0) * kC, kC, r0,
                          p.rows - 1, br, lane, eps, v, mu, rstd);
#pragma unroll
    for (int k = 0; k < kLn; ++k)
      if (lane == 0 && r0 + svdd::cnn::kWarps * k < p.rows) {
        mu_s[r0 + svdd::cnn::kWarps * k] = mu[k];
        rstd_s[r0 + svdd::cnn::kWarps * k] = rstd[k];
      }
  }
  __syncthreads();

  const int cg = warp % kColGroups;
  const int g = lane >> 2, t = lane & 3;
  int m0, mc;
  svdd::cnn::warp_tiles(p, &m0, &mc);
  // hn of this lane's pair at (row, col), from the row's statistics
  auto hn_pair = [&](int row, int col, float mu, float rstd, float& h0, float& h1) {
    float x0, x1, b0, b1;
    svdd::cnn::load2(x + base + static_cast<size_t>(row) * kC + col, x0, x1);
    svdd::cnn::load2(brn + col, b0, b1);
    h0 = (svdd::round_to<T>(x0 + b0) - mu) * rstd;
    h1 = (svdd::round_to<T>(x1 + b1) - mu) * rstd;
  };
  // dhs and dhn = dhs * g, rounded to T as the reference VJP rounds them
  // under ref_round
  auto dhs_of = [&](float a) { return ref_round ? svdd::round_to<T>(a) : a; };
  auto dhn_of = [&](float a, float g) {
    return ref_round ? svdd::round_to<T>(svdd::round_to<T>(a) * svdd::round_to<T>(g))
                     : a * g;
  };
  // each row's sums of dhn and dhn * hn over this warp's 32 columns
#pragma unroll
  for (int mi = 0; mi < kMaxM; ++mi) {
    if (mi >= mc) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = 16 * (m0 + mi) + g + 8 * h;  // row within the pass
      const int row = p.r0 + lr;
      float s1 = 0.f, s2 = 0.f;
      if (row < L) {
        const float mu = mu_s[lr], rstd = rstd_s[lr];
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          const int col = 32 * cg + 8 * ni + 2 * t;
          float h0, h1;
          hn_pair(row, col, mu, rstd, h0, h1);
          const float d0 = dhn_of(acc[mi][ni][2 * h], ln_g[col]);
          const float d1 = dhn_of(acc[mi][ni][2 * h + 1], ln_g[col + 1]);
          s1 += d0 + d1;
          s2 += d0 * h0 + d1 * h1;
        }
      }
      // the row's 32 columns of this warp lie in the 4 lanes of its quad
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
      if (t == 0) {
        ex[(lr * kColGroups + cg) * 2] = s1;
        ex[(lr * kColGroups + cg) * 2 + 1] = s2;
      }
    }
  }
  __syncthreads();

  float sg[kNT][2] = {}, sb[kNT][2] = {}, sr[kNT][2] = {};
#pragma unroll
  for (int mi = 0; mi < kMaxM; ++mi) {
    if (mi >= mc) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = 16 * (m0 + mi) + g + 8 * h;
      const int row = p.r0 + lr;
      if (row >= L) continue;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < kColGroups; ++q) {  // the four column groups in order
        s1 += ex[(lr * kColGroups + q) * 2];
        s2 += ex[(lr * kColGroups + q) * 2 + 1];
      }
      const float m1 = s1 * (1.f / kC), m2 = s2 * (1.f / kC);
      const float mu = mu_s[lr], rstd = rstd_s[lr];
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int col = 32 * cg + 8 * ni + 2 * t;
        const size_t at = base + static_cast<size_t>(row) * kC + col;
        float hn[2], dh0[2], c[2];
        hn_pair(row, col, mu, rstd, hn[0], hn[1]);
        svdd::cnn::load2(ct + at, c[0], c[1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = dhs_of(acc[mi][ni][2 * h + e]);
          const float dhn = dhn_of(a, ln_g[col + e]);
          dh0[e] = rstd * (dhn - m1 - hn[e] * m2);
          sg[ni][e] += ref_round ? svdd::round_to<T>(a * svdd::round_to<T>(hn[e]))
                                 : a * hn[e];
          sb[ni][e] += a;
          sr[ni][e] += dhs_of(dh0[e]);
          c[e] += svdd::round_to<T>(dh0[e]);
        }
        svdd::cnn::store2(dx + at, c[0], c[1]);
      }
    }
  }
  const size_t blk = static_cast<size_t>(n) * gridDim.x + blockIdx.x;
  svdd::cnn::column_sums(sg, red, dg_part + blk * kC);
  svdd::cnn::column_sums(sb, red, db_part + blk * kC);
  svdd::cnn::column_sums(sr, red, dbr_part + blk * kC);
}

// 3. dW_t partial over rows [chunk * rows_per_chunk, ...): the GEMM
// dW_t[in][out] = sum over rows r of h[r + off_t][in] * dacc[r][out],
// rows r = n * L + i reading h row i + off_t of the same sequence (zero
// outside it). A block is 8 warps over the 128 x 128 tile, each 64 x 32
// (4 m16 x 4 n8 tiles); rows stream through a 3-stage cp.async ring of
// 32 rows of each operand.
constexpr int kWThreads = 256;  // 8 warps: 2 along the rows of dW, 4 along its columns
constexpr int kWRows = 32;
constexpr int kWStages = 3;
constexpr int kWLd = kC + 8;  // elements a padded row, f32 or bf16

template <typename T>
constexpr size_t wgrad_smem_bytes() {
  return static_cast<size_t>(2 * kWStages * kWRows * kWLd) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kWThreads, 2)
    cnn_bwd_wgrad_kernel(const T* __restrict__ h, const T* __restrict__ dacc,
                         float* __restrict__ dw_part, svdd::Taps taps, int N,
                         int L, int rows_per_chunk) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kE = 16 / sizeof(T);            // elements a 16-byte chunk
  constexpr int kChunks = kC / kE;              // chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);           // [kWStages][kWRows][kWLd]: h
  T* Bs = As + kWStages * kWRows * kWLd;        // the same for dacc

  const int chunk = blockIdx.x, tap = blockIdx.y, chunks = gridDim.x;
  const int off = taps.off[tap];
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
      const T* a_src = a_in ? h + (static_cast<size_t>(seq[j]) * L + src) * kC + c * kE : h;
      const T* b_src = in ? dacc + static_cast<size_t>(R) * kC + c * kE : dacc;
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
      // A[m = in][k = row] and B[k = row][n = out] are both stored by
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
      // bank 8t + g, no conflicts
      const float* Af = reinterpret_cast<const float*>(A);
      const float* Bf = reinterpret_cast<const float*>(B);
#pragma unroll
      for (int kk = 0; kk < kWRows / 8; ++kk) {
        const float* ar = Af + (8 * kk + t) * kWLd;
        const float* br = Bf + (8 * kk + t) * kWLd;
        uint32_t ab[4][4], as[4][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int m = 64 * wm + 16 * mi + g;
          const float v[4] = {ar[m], ar[m + 8], ar[4 * kWLd + m], ar[4 * kWLd + m + 8]};
#pragma unroll
          for (int e = 0; e < 4; ++e) mma::split_tf32(__float_as_uint(v[e]), ab[mi][e], as[mi][e]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int nn = 32 * wn + 8 * ni + g;
          mma::split_tf32(__float_as_uint(br[nn]), bb[ni][0], bs[ni][0]);
          mma::split_tf32(__float_as_uint(br[4 * kWLd + nn]), bb[ni][1], bs[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_tf32(acc[mi][ni], as[mi], bb[ni][0], bb[ni][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_tf32(acc[mi][ni], ab[mi], bs[ni][0], bs[ni][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_tf32(acc[mi][ni], ab[mi], bb[ni][0], bb[ni][1]);
      }
    }
  }

  float* out = dw_part + (static_cast<size_t>(tap) * chunks + chunk) * kC * kC;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 64 * wm + 16 * mi + g + 8 * hh;
        const int nn = 32 * wn + 8 * ni + 2 * t;
        svdd::cnn::store2(out + m * kC + nn, acc[mi][ni][2 * hh],
                          acc[mi][ni][2 * hh + 1]);
      }
}

template <typename T>
int launch(const void* x, const void* bias_row, const void* ln_g,
           const void* ln_b, const void* wt, const void* wflip, const void* cb,
           const void* ct, void* dx, void* dbr, void* dw, void* dg, void* db,
           void* dcb, void* mask_out, void* scratch_t, void* scratch_f,
           const int* offsets,
           int k_live, int n, int l, int chunks, float eps, int ref_round,
           cudaStream_t stream) {
  const svdd::Taps taps = svdd::make_taps(offsets, k_live);
  const int passes = (l + kPassRows - 1) / kPassRows;
  const size_t nlc = static_cast<size_t>(n) * l * kC;
  T* h_buf = static_cast<T*>(scratch_t);
  T* dacc = h_buf + nlc;
  float* dw_part = static_cast<float*>(scratch_f);
  const size_t part = static_cast<size_t>(n) * passes * kC;
  float* dcb_part = dw_part + static_cast<size_t>(k_live) * chunks * kC * kC;
  float* dg_part = dcb_part + part;
  float* db_part = dg_part + part;
  float* dbr_part = db_part + part;

  const size_t smem = svdd::cnn::smem_bytes<T>(l);
  if (smem > static_cast<size_t>(svdd::cnn::kSmemMax)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cnn_bwd_mask_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(cnn_bwd_dgrad_ln_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  constexpr size_t wsmem = wgrad_smem_bytes<T>();
  e = cudaFuncSetAttribute(cnn_bwd_wgrad_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(wsmem));
  if (e != cudaSuccess) return e;
  const dim3 grid(passes, n);
  const T* xp = static_cast<const T*>(x);
  const T* brp = static_cast<const T*>(bias_row);
  const float* gp = static_cast<const float*>(ln_g);
  const T* ctp = static_cast<const T*>(ct);
  cnn_bwd_mask_kernel<T><<<grid, kThreads, smem, stream>>>(
      xp, brp, gp, static_cast<const float*>(ln_b), static_cast<const T*>(wt),
      static_cast<const float*>(cb), ctp, h_buf, dacc,
      static_cast<unsigned char*>(mask_out), dcb_part, taps, k_live, l, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cnn_bwd_dgrad_ln_kernel<T><<<grid, kThreads, smem, stream>>>(
      xp, brp, gp, static_cast<const T*>(wflip), ctp, dacc, static_cast<T*>(dx),
      dg_part, db_part, dbr_part, taps, k_live, l, eps, ref_round);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long total = static_cast<long long>(n) * l;
  const int rows_per_chunk = static_cast<int>((total + chunks - 1) / chunks);
  cnn_bwd_wgrad_kernel<T><<<dim3(chunks, k_live), kWThreads, wsmem, stream>>>(
      h_buf, dacc, dw_part, taps, n, l, rows_per_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* out_dw = static_cast<float*>(dw);
  if ((e = svdd::reduce_partials(dw_part, out_dw, k_live, chunks,
                                 static_cast<long long>(kC) * kC, stream)))
    return e;
  if ((e = svdd::reduce_partials(dcb_part, static_cast<float*>(dcb), 1,
                                 n * passes, kC, stream)))
    return e;
  if ((e = svdd::reduce_partials(dg_part, static_cast<float*>(dg), 1,
                                 n * passes, kC, stream)))
    return e;
  if ((e = svdd::reduce_partials(db_part, static_cast<float*>(db), 1,
                                 n * passes, kC, stream)))
    return e;
  return svdd::reduce_partials(dbr_part, static_cast<float*>(dbr), n, passes,
                               kC, stream);
}

}  // namespace

// Inputs as svdd_cnn_layer takes them (wt: the live-tap weights, each
// transposed to [out][in]), plus wflip (k_live, 128, 128) in T: the
// live-tap weights in reverse tap order, untransposed, [in][out]; and ct
// (N, L, 128) in T. Outputs: dx (N, L, 128) in T; dbr (N, 128), dw
// (k_live, 128, 128), dg, db, dcb (128,) in f32; mask_out (nullable)
// (N, L, 128) bytes, the relu mask used (1 where y > 0). Scratch:
// scratch_t 2*N*L*128 elements of T; scratch_f k_live*chunks*128*128 +
// 4*N*ceil(L/240)*128 floats. The sequence must fit a block's shared
// memory, as for svdd_cnn_layer. dtype: 0 float32, 1 bfloat16. ref_round:
// round the dgrad pass as cnn_layer_reference's VJP (see the top).
extern "C" int svdd_cnn_layer_bwd(const void* x, const void* bias_row,
                                  const void* ln_g, const void* ln_b,
                                  const void* wt, const void* wflip,
                                  const void* cb, const void* ct, void* dx,
                                  void* dbr, void* dw, void* dg, void* db,
                                  void* dcb, void* mask_out, void* scratch_t,
                                  void* scratch_f,
                                  const void* offsets, int k_live, int n,
                                  int l, int c, int chunks, float eps,
                                  int ref_round, int dtype, void* stream) {
  if (c != kC || k_live < 1 || k_live > svdd::kMaxTaps || n < 1 || l < 1 ||
      chunks < 1)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, bias_row, ln_g, ln_b, wt, wflip, cb, ct, dx, dbr,
                         dw, dg, db, dcb, mask_out, scratch_t, scratch_f, offs,
                         k_live, n, l, chunks, eps, ref_round, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bias_row, ln_g, ln_b, wt, wflip, cb, ct,
                                 dx, dbr, dw, dg, db, dcb, mask_out, scratch_t,
                                 scratch_f, offs, k_live, n, l, chunks, eps,
                                 ref_round, s);
  return cudaErrorInvalidValue;
}
