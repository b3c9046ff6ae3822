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
// products, and every product summed in f32.
//
// What bounds it on an H100: three tap-product passes of the forward's
// size (recompute, dgrad, wgrad), 3 * 2*L*k_live*C*C flops per
// sequence, on the f32 FMA pipes. Design, four launches on the stream:
//  1. mask: per (sequence, 64-row tile) the forward's own prologue and
//     tap loop (cnn_layer.cuh), so the recomputed y, and the relu mask,
//     are the forward's bit for bit; writes dacc and the tile's rows of
//     h (both in T), and the tile's column sums of dacc;
//  2. dgrad + LayerNorm backward: per tile, the same tap loop over the
//     dacc rows with the flipped, transposed live-tap weights (the live
//     offsets are symmetric, so tap t of the flipped stack has offset
//     off_t and weight W_{k-1-t}^T); the LN backward runs in the
//     epilogue, since a tile holds whole 128-channel rows;
//  3. wgrad: per (tap, chunk of rows) a 128x128 tiled GEMM
//     (gemm.cuh) of h shifted by the tap's offset against dacc;
//  4. deterministic reduces of every per-block partial sum (gemm.cuh).
// The TPU accumulated dW and the per-channel sums over a sequential
// grid; blocks on the card run in parallel, so each writes a partial
// and a second pass sums them in a fixed order (no float atomics, so a
// run repeats bit for bit).
#include "cnn_layer.cuh"
#include "gemm.cuh"

namespace {

using svdd::cnn::kC;
using svdd::cnn::kChunk;
using svdd::cnn::kThreads;
using svdd::cnn::kTileRows;

// Column sums over the block's rows of v[i][j] (rows ty+16i, column
// tx+16j), summed in a fixed order: red is a [16][kC] f32 scratch.
__device__ __forceinline__ void column_sums(const float (&v)[4][8],
                                            float* red, float* out) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  __syncthreads();  // red free
#pragma unroll
  for (int j = 0; j < 8; ++j)
    red[ty * kC + tx + 16 * j] = v[0][j] + v[1][j] + v[2][j] + v[3][j];
  __syncthreads();
  if (tid < kC) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[r * kC + tid];
    out[tid] = s;
  }
}

// 1. recompute y, mask the cotangent: dacc = T(ct if y > 0 else 0)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cnn_bwd_mask_kernel(const T* __restrict__ x, const T* __restrict__ bias_row,
                        const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ w,
                        const float* __restrict__ cb, const T* __restrict__ ct,
                        T* __restrict__ h_out, T* __restrict__ dacc,
                        unsigned char* __restrict__ mask_out,
                        float* __restrict__ dcb_part, svdd::Taps taps,
                        int k_live, int L, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  T* hs = reinterpret_cast<T*>(smem + kChunk * kC * sizeof(float));

  const int n = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const size_t base = static_cast<size_t>(n) * L * kC;
  int lo, hi;
  svdd::cnn::tile_halo(taps, k_live, L, r0, &lo, &hi);
  svdd::cnn::ln_prologue<T>(x + base, bias_row + static_cast<size_t>(n) * kC,
                            ln_g, ln_b, eps, lo, hi, hs);
  float acc[4][8];
  svdd::cnn::tap_products<T>(hs, w, taps, k_live, L, r0, ws, acc);

  // this tile's rows of h, for the wgrad pass
  const int rows = min(kTileRows, L - r0);
  for (int e = threadIdx.x; e < rows * kC; e += kThreads)
    h_out[base + static_cast<size_t>(r0) * kC + e] = hs[r0 * kC + e];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float d[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      d[i][j] = 0.f;
      if (row >= L) continue;
      const size_t at = base + static_cast<size_t>(row) * kC + col;
      const bool on = svdd::cnn::conv_out<T>(acc[i][j], cb[col]) > 0.f;
      d[i][j] = on ? svdd::to_f(ct[at]) : 0.f;
      dacc[at] = svdd::from_f<T>(d[i][j]);
      if (mask_out) mask_out[at] = on;
    }
  }
  const size_t blk = static_cast<size_t>(n) * gridDim.x + blockIdx.x;
  column_sums(d, ws, dcb_part + blk * kC);
}

// 2. dhs = the mirrored tap sum over dacc, then the LayerNorm backward
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cnn_bwd_dgrad_ln_kernel(const T* __restrict__ x,
                            const T* __restrict__ bias_row,
                            const float* __restrict__ ln_g,
                            const T* __restrict__ wt, const T* __restrict__ ct,
                            const T* __restrict__ dacc, T* __restrict__ dx,
                            float* __restrict__ dg_part,
                            float* __restrict__ db_part,
                            float* __restrict__ dbr_part, svdd::Taps taps,
                            int k_live, int L, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  T* hs = reinterpret_cast<T*>(smem + kChunk * kC * sizeof(float));
  __shared__ float mu_s[kTileRows], rstd_s[kTileRows];

  const int n = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const size_t base = static_cast<size_t>(n) * L * kC;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int lo, hi;
  svdd::cnn::tile_halo(taps, k_live, L, r0, &lo, &hi);
  for (int e = tid; e < (hi - lo + 1) * kC; e += kThreads)
    hs[lo * kC + e] = dacc[base + static_cast<size_t>(lo) * kC + e];

  // LN statistics of the tile's rows, as the forward computes them
  const T* brn = bias_row + static_cast<size_t>(n) * kC;
  float br[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) br[j] = svdd::to_f(brn[lane + 32 * j]);
  const int rows = min(kTileRows, L - r0);
  for (int r = warp; r < rows; r += kThreads / 32) {
    float v[4], mu, rstd;
    svdd::cnn::ln_row<T>(x + base + static_cast<size_t>(r0 + r) * kC, br,
                         lane, eps, v, &mu, &rstd);
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }

  float acc[4][8];
  svdd::cnn::tap_products<T>(hs, wt, taps, k_live, L, r0, ws, acc);

  const int tx = tid & 15, ty = tid >> 4;
  float pg[4][8], pb[4][8], pr[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = r0 + r;
    const bool valid = row < L;
    const float mu = valid ? mu_s[r] : 0.f;
    const float rstd = valid ? rstd_s[r] : 0.f;
    float hn[8], dhn[8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      hn[j] = 0.f;
      dhn[j] = 0.f;
      if (valid) {
        const float h0 = svdd::round_to<T>(
            svdd::to_f(x[base + static_cast<size_t>(row) * kC + col]) +
            svdd::to_f(brn[col]));
        hn[j] = (h0 - mu) * rstd;
        dhn[j] = acc[i][j] * ln_g[col];
      }
      s1 += dhn[j];
      s2 += dhn[j] * hn[j];
    }
    // the row's 128 channels live in the 16 lanes of this ty
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 * (1.f / kC), m2 = s2 * (1.f / kC);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      pg[i][j] = valid ? acc[i][j] * hn[j] : 0.f;
      pb[i][j] = valid ? acc[i][j] : 0.f;
      pr[i][j] = 0.f;
      if (!valid) continue;
      const float dh0 = rstd * (dhn[j] - m1 - hn[j] * m2);
      pr[i][j] = dh0;
      const size_t at = base + static_cast<size_t>(row) * kC + col;
      dx[at] = svdd::from_f<T>(svdd::round_to<T>(dh0) + svdd::to_f(ct[at]));
    }
  }
  const size_t blk = static_cast<size_t>(n) * gridDim.x + blockIdx.x;
  column_sums(pg, ws, dg_part + blk * kC);
  column_sums(pb, ws, db_part + blk * kC);
  column_sums(pr, ws, dbr_part + blk * kC);
}

// 3. dW_t partial over rows [chunk*rows_per_chunk, ...): h shifted by
// off_t (rows n*L + i, reading h row i + off_t) against dacc
template <typename T>
__global__ void __launch_bounds__(svdd::kGemmThreads, 2)
    cnn_bwd_wgrad_kernel(const T* __restrict__ h, const T* __restrict__ dacc,
                         float* __restrict__ dw_part, svdd::Taps taps, int N,
                         int L, int rows_per_chunk) {
  __shared__ __align__(16) svdd::GemmSmem sm;
  const int chunk = blockIdx.x, t = blockIdx.y, chunks = gridDim.x;
  const int off = taps.off[t];
  const long long total = static_cast<long long>(N) * L;
  const long long r_begin = static_cast<long long>(chunk) * rows_per_chunk;
  const long long r_end = min(total, r_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const svdd::StageCoords sc = svdd::stage_coords<svdd::ALayout::MMajor>(tid);
  auto load_stage = [&](int s, float* a_reg, float* b_reg) {
    const long long r = r_begin + static_cast<long long>(s) * svdd::kBK + sc.a_k;
#pragma unroll
    for (int e = 0; e < 4; ++e) a_reg[e] = b_reg[e] = 0.f;
    if (r >= r_end) return;
    const long long n = r / L;
    const int i = static_cast<int>(r - n * L);
    const int src = i + off;
    if (src >= 0 && src < L)
      svdd::load4<T>(h + (static_cast<size_t>(n) * L + src) * kC + sc.a_m, a_reg);
    svdd::load4<T>(dacc + static_cast<size_t>(r) * kC + sc.b_n, b_reg);
  };
  const int nk = static_cast<int>((r_end - r_begin + svdd::kBK - 1) / svdd::kBK);
  float acc[8][8];
  svdd::gemm_tile<svdd::ALayout::MMajor>(sm, nk, load_stage, acc);
  const int tx = tid & 15, ty = tid >> 4;
  float* out = dw_part + (static_cast<size_t>(t) * chunks + chunk) * kC * kC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int a = svdd::acc_row(i, ty);
    svdd::store4<float>(out + a * kC + tx * 4, acc[i]);
    svdd::store4<float>(out + a * kC + 64 + tx * 4, acc[i] + 4);
  }
}

template <typename T>
int launch(const void* x, const void* bias_row, const void* ln_g,
           const void* ln_b, const void* w, const void* wt, const void* cb,
           const void* ct, void* dx, void* dbr, void* dw, void* dg, void* db,
           void* dcb, void* mask_out, void* scratch_t, void* scratch_f,
           const int* offsets,
           int k_live, int n, int l, int chunks, float eps,
           cudaStream_t stream) {
  const svdd::Taps taps = svdd::make_taps(offsets, k_live);
  const int tiles = (l + kTileRows - 1) / kTileRows;
  const size_t nlc = static_cast<size_t>(n) * l * kC;
  T* h_buf = static_cast<T*>(scratch_t);
  T* dacc = h_buf + nlc;
  float* dw_part = static_cast<float*>(scratch_f);
  const size_t part = static_cast<size_t>(n) * tiles * kC;
  float* dcb_part = dw_part + static_cast<size_t>(k_live) * chunks * kC * kC;
  float* dg_part = dcb_part + part;
  float* db_part = dg_part + part;
  float* dbr_part = db_part + part;

  const size_t smem = svdd::cnn::smem_bytes<T>(l);
  cudaError_t e = cudaFuncSetAttribute(
      cnn_bwd_mask_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(cnn_bwd_dgrad_ln_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, n);
  const T* xp = static_cast<const T*>(x);
  const T* brp = static_cast<const T*>(bias_row);
  const float* gp = static_cast<const float*>(ln_g);
  const T* ctp = static_cast<const T*>(ct);
  cnn_bwd_mask_kernel<T><<<grid, kThreads, smem, stream>>>(
      xp, brp, gp, static_cast<const float*>(ln_b), static_cast<const T*>(w),
      static_cast<const float*>(cb), ctp, h_buf, dacc,
      static_cast<unsigned char*>(mask_out), dcb_part, taps, k_live, l, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cnn_bwd_dgrad_ln_kernel<T><<<grid, kThreads, smem, stream>>>(
      xp, brp, gp, static_cast<const T*>(wt), ctp, dacc, static_cast<T*>(dx),
      dg_part, db_part, dbr_part, taps, k_live, l, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long total = static_cast<long long>(n) * l;
  const int rows_per_chunk = static_cast<int>((total + chunks - 1) / chunks);
  cnn_bwd_wgrad_kernel<T><<<dim3(chunks, k_live), svdd::kGemmThreads, 0, stream>>>(
      h_buf, dacc, dw_part, taps, n, l, rows_per_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* out_dw = static_cast<float*>(dw);
  if ((e = svdd::reduce_partials(dw_part, out_dw, k_live, chunks,
                                 static_cast<long long>(kC) * kC, stream)))
    return e;
  if ((e = svdd::reduce_partials(dcb_part, static_cast<float*>(dcb), 1,
                                 n * tiles, kC, stream)))
    return e;
  if ((e = svdd::reduce_partials(dg_part, static_cast<float*>(dg), 1,
                                 n * tiles, kC, stream)))
    return e;
  if ((e = svdd::reduce_partials(db_part, static_cast<float*>(db), 1,
                                 n * tiles, kC, stream)))
    return e;
  return svdd::reduce_partials(dbr_part, static_cast<float*>(dbr), n, tiles,
                               kC, stream);
}

}  // namespace

// Inputs as svdd_cnn_layer takes them, plus wt (k_live, 128, 128) in T:
// the live-tap weights flipped along taps and transposed, and ct
// (N, L, 128) in T. Outputs: dx (N, L, 128) in T; dbr (N, 128), dw
// (k_live, 128, 128), dg, db, dcb (128,) in f32; mask_out (nullable)
// (N, L, 128) bytes, the relu mask used (1 where y > 0). Scratch: scratch_t
// 2*N*L*128 elements of T; scratch_f k_live*chunks*128*128 +
// 4*N*ceil(L/64)*128 floats. dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_cnn_layer_bwd(const void* x, const void* bias_row,
                                  const void* ln_g, const void* ln_b,
                                  const void* w, const void* wt,
                                  const void* cb, const void* ct, void* dx,
                                  void* dbr, void* dw, void* dg, void* db,
                                  void* dcb, void* mask_out, void* scratch_t,
                                  void* scratch_f,
                                  const void* offsets, int k_live, int n,
                                  int l, int c, int chunks, float eps,
                                  int dtype, void* stream) {
  if (c != kC || k_live < 1 || k_live > svdd::kMaxTaps || n < 1 || l < 1 ||
      chunks < 1)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, bias_row, ln_g, ln_b, w, wt, cb, ct, dx, dbr, dw,
                         dg, db, dcb, mask_out, scratch_t, scratch_f, offs,
                         k_live, n, l, chunks, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bias_row, ln_g, ln_b, w, wt, cb, ct, dx,
                                 dbr, dw, dg, db, dcb, mask_out, scratch_t,
                                 scratch_f, offs, k_live, n, l, chunks, eps,
                                 s);
  return cudaErrorInvalidValue;
}
