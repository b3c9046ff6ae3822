// Backward of the SAME-padded 1-D convolution y = conv1d_shifted(x, W, d)
// (y[j] = sum over live taps t of x[j + off_t] @ W_t): given the output
// cotangent ct,
//   dx[j]  = sum_t ct[j - off_t] @ W_t^T      (dgrad)
//   dW_t   = x^T @ shift(ct, -off_t)          (wgrad, summed over rows)
// Dead taps (|off| >= L) get no gradient here; the wrapper leaves their
// rows of dW at zero.
//
// Replaces svdd_tpu/ops/conv1d_bwd_pallas.py:conv1d_bwd_pallas
// (pallas_call at :141, body _bwd_kernel :52). The conv forward stays a
// library convolution in both packages (conv1d_bwd_pallas.py:27-31).
//
// What bounds it on an H100: operations, 2 * 2*C_in*C_out per (row, live
// tap) whose source lies inside the sequence (dgrad and wgrad), on the
// tensor cores: bf16 mma, or 3xTF32 in f32 (495/3 TFLOP/s). At the value
// tower's six k=5 convs at N=512 that is 1450.7 GFLOP: 8.79 ms on
// 3xTF32, 1.47 ms in bf16, against 1.31 GB (f32) of x, ct, dx, W and dW,
// 0.39 ms at 3.35 TB/s. Design,
// two tensor-core GEMMs and, where the rows are split, a reduce:
//  * dgrad: the tap routine of conv_mma.cuh, rows (n, j) x columns Cin,
//    summed over (Cout chunk, live tap): the mirrored tap sum
//    dx[j] = sum_u ct[j + off'_u] . W_{k-1-u}^T with off'_u = -off_{k-1-u}
//    (ascending), whose B operand, stored by rows of Cin, is W_{k-1-u}
//    itself: the wrapper passes the live taps in reverse order. Each ct
//    row of a tile and its halo is loaded once per Cout chunk and read by
//    every tap;
//  * wgrad: per (row chunk, 128 x 128 tile of dW_t, tap) the GEMM
//    dW_t[ci][co] = sum over rows r of x[r + off_t][ci] ct[r][co], rows
//    streamed through a 3-stage cp.async ring of 64 rows of each
//    operand: the template of B6's wgrad (cnn_layer_bwd.cu) with tile
//    offsets and C_in != C_out (bf16: ldmatrix.trans fragments; f32:
//    3xTF32 on scalar fragment loads, 8-element row padding keeping them
//    free of bank conflicts, and a partial sum a stage as in
//    conv_mma.cuh's Ring::kFlush); the chunks' partials are summed by a
//    deterministic second pass (reduce.cuh) instead of the TPU's
//    sequential-grid accumulator, or written as dW where there is one
//    chunk. The chunks (ops/conv1d.py, _build.row_chunks) fill the card
//    twice over; the smallest tower conv (2048 rows, 1280 -> 1536) is
//    600 blocks.
#include "conv_mma.cuh"
#include "reduce.cuh"

namespace {

namespace conv = svdd::conv;
namespace mma = svdd::mma;

template <typename T>
__global__ void __launch_bounds__(conv::kThreads, conv::Ring<T>::kBlocks)
    conv_bwd_dgrad_kernel(const T* __restrict__ ct, const T* __restrict__ wflip,
                          T* __restrict__ dx, conv::Plan plan, int N, int L,
                          int Cin, int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long NL = static_cast<long long>(N) * L;
  long long m0;
  int n0;
  conv::tile_origin(Cin, &m0, &n0);
  float acc[conv::kMT][conv::kNT][4];
  conv::tap_gemm<T, false>(ct, wflip, plan, NL, L, Cout, Cin, m0, n0, nullptr,
                           nullptr, 0, smem, acc);
  conv::store_tile<T>(acc, m0, n0, NL, Cin, dx, [](float a, int) { return a; });
}

// dW_t[a0.., b0..] partial over rows [chunk * rows_per_chunk, ...). A
// block is 8 warps over the 128 x 128 tile, each 64 x 32 (4 m16 x 4 n8
// tiles). 64 rows a stage ran 7% faster than 32 in bf16 and the same in
// f32 on an H100 (scripts/probe_conv_mma.py, variant wgrad_rows32).
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
__global__ void __launch_bounds__(kWThreads, wgrad_blocks<T>())
    conv_bwd_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                          float* __restrict__ dw_part, svdd::Taps taps, int N,
                          int L, int Cin, int Cout, int rows_per_chunk) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kE = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int kChunks = kWTile / kE;        // chunks a tile row
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);         // [kWStages][kWRows][kWLd]: x
  T* Bs = As + kWStages * kWRows * kWLd;      // the same for ct

  const int chunk = blockIdx.x, chunks = gridDim.x, tap = blockIdx.z;
  const int tiles_b = Cout / kWTile;
  const int a0 = (blockIdx.y / tiles_b) * kWTile;
  const int b0 = (blockIdx.y % tiles_b) * kWTile;
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
        conv::store2(out + static_cast<size_t>(m) * Cout + nn, acc[mi][ni][2 * hh],
                     acc[mi][ni][2 * hh + 1]);
      }
}

template <typename T>
int launch(const void* x, const void* wflip, const void* ct, void* dx, void* dw,
           void* scratch_f, const int* offsets, int k_live, int n, int l,
           int cin, int cout, int chunks, cudaStream_t stream) {
  // the dgrad's mirrored taps: offsets -off_{k-1-u}, ascending
  int mirrored[svdd::kMaxTaps];
  for (int u = 0; u < k_live; ++u) mirrored[u] = -offsets[k_live - 1 - u];
  conv::Plan plan;
  if (!conv::make_plan(mirrored, k_live, &plan)) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(n) * l;
  const long long blocks = conv::grid_blocks(rows, cin);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv_bwd_dgrad_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       conv::Ring<T>::kSmemBytes);
  if (e != cudaSuccess) return e;
  conv_bwd_dgrad_kernel<T><<<static_cast<unsigned>(blocks), conv::kThreads,
                             conv::Ring<T>::kSmemBytes, stream>>>(
      static_cast<const T*>(ct), static_cast<const T*>(wflip), static_cast<T*>(dx),
      plan, n, l, cin, cout);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t wsmem = wgrad_smem_bytes<T>();
  e = cudaFuncSetAttribute(conv_bwd_wgrad_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(wsmem));
  if (e != cudaSuccess) return e;
  const int rows_per_chunk = static_cast<int>((rows + chunks - 1) / chunks);
  float* part = chunks > 1 ? static_cast<float*>(scratch_f) : static_cast<float*>(dw);
  const svdd::Taps taps = svdd::make_taps(offsets, k_live);
  conv_bwd_wgrad_kernel<T><<<dim3(chunks, (cin / kWTile) * (cout / kWTile), k_live),
                             kWThreads, wsmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ct), part, taps, n, l, cin,
      cout, rows_per_chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (chunks == 1) return cudaSuccess;
  return svdd::reduce_partials(part, static_cast<float*>(dw), k_live, chunks,
                               static_cast<long long>(cin) * cout, stream);
}

}  // namespace

// x (N, L, Cin), ct (N, L, Cout) in the activation type; wflip (k_live,
// Cin, Cout) in that type, the live taps of the (K, Cin, Cout) kernel in
// reverse order; offsets (k_live,) host ints, the live taps' offsets,
// ascending. Outputs: dx (N, L, Cin) in the activation type, dw (k_live,
// Cin, Cout) f32 in the forward's tap order. scratch_f:
// chunks*k_live*Cin*Cout floats (unused when chunks is 1). Cin and Cout
// multiples of 128; every tensor 16-byte aligned. dtype: 0 float32,
// 1 bfloat16.
extern "C" int svdd_conv1d_bwd(const void* x, const void* wflip, const void* ct,
                               void* dx, void* dw, void* scratch_f,
                               const void* offsets, int k_live, int n, int l,
                               int cin, int cout, int chunks, int dtype,
                               void* stream) {
  if (n < 1 || l < 1 || cin < conv::kBN || cin % conv::kBN || cout < conv::kBN ||
      cout % conv::kBN || k_live < 1 || k_live > svdd::kMaxTaps || chunks < 1 ||
      (cin / kWTile) * (cout / kWTile) > 65535)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wflip, ct, dx, dw, scratch_f, offs, k_live, n, l,
                         cin, cout, chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wflip, ct, dx, dw, scratch_f, offs, k_live,
                                 n, l, cin, cout, chunks, s);
  return cudaErrorInvalidValue;
}
