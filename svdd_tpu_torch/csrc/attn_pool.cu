// Pairwise attention pool of the Enformer value tower, alone (B4) or
// fused with the next conv block's BN affine, activation and im2col
// (B3, compile-time flag IM2COL).
//
// Replaces svdd_tpu/ops/attn_pool_pallas.py:
//   attn_pool_wlogits_lnc_pallas            (pallas_call :916, body :867)
//   pool_prologue_im2col_wlogits_lnc_pallas (pallas_call :1071, body :1008)
//
// Per pair p of rows of s = x (+ residual, added in x's type):
//   d = s[2p] - s[2p+1] (f32), ld = T(d) @ W (f32 sums),
//   pooled = s[2p+1] + d * sigmoid(ld)
// and when L is odd the last pair is (s[L-1], 0) with its weight forced
// to 1, so it pools to s[L-1]. B3 then writes y = T(act(pooled * scale +
// shift)) into the k_live im2col slabs of the next conv:
//   cols[n, q, j*C + c] = y[n, q + off_j, c], zero outside [0, LH).
//
// What bounds it on an H100: at the six fused pools of a value forward
// at N = 5120, the product is 2 N LH C^2 = 1.41 TFLOP (8.6 ms on 3xTF32's
// 495/3 TFLOP/s, 1.4 ms in bf16) against 30.1 GB in f32 of x, the
// residual and the im2col slabs (9.0 ms at 3.35 TB/s; 4.5 ms in bf16):
// bytes, narrowly in f32 and clearly in bf16. Design:
//  * the product on the tensor cores, by conv_mma.cuh's warp routine
//    (mma_stage: bf16 m16n8k16; f32 3xTF32 with a partial sum a stage,
//    since the tensor cores' truncating accumulation drifts over a long
//    chain): rows (n, p) by columns of W, a 128 x 128 tile a block of 8
//    warps, summed over k chunks of C;
//  * the A operand is computed, not copied: a stage lands the pair rows
//    x[2p], x[2p+1] (and the residual's) of its k chunk by cp.async, a
//    row at a time since pairs do not run on across sequences at odd L
//    (a missing partner and the rows past the end zero-filled), and one
//    pass between two barriers writes T(d) into the padded slab ldmatrix
//    reads; each thread's pass reads only the chunks it copied itself;
//  * the column tiles of a row tile are neighbours in the grid (the
//    column tile fastest, conv::tile_origin), so they run together and
//    their pair rows come from HBM once and from L2 for the siblings;
//  * the pass keeps s[2p] and s[2p+1] of the block's own 128 channels,
//    rounded to T, in shared memory (XOR-swizzled rows): the epilogue
//    reads x and the residual no second time;
//  * the epilogue blends, activates and rounds in registers, stages the
//    tile in shared memory over s[2p] and writes each slab row, and the
//    zero rows at the sequence ends, in 16-byte streaming stores along
//    the row.
// One block an SM (223 KB of shared memory in f32, 201 KB in bf16). On
// an H100 it runs at about a sixth of its bound (PERF.md, measured by
// scripts/probe_attn_pool.py): each column tile moves the four raw pair
// rows of its row tile through L2 and shared memory for its product,
// four times the bytes of T(d), and the loop waits on them; the mma,
// the slab stores and the pass come after. Materialising T(d) in a
// first kernel and running the product as conv_mma.cuh's tap routine
// cut those bytes, but read x and the residual twice and ran slower in
// f32; a deeper ring of smaller stages ran slower in both types.
#include "conv_mma.cuh"

namespace {

namespace conv = svdd::conv;
namespace mma = svdd::mma;
using conv::kBM;
using conv::kBN;
using conv::kMT;
using conv::kNT;
using conv::kThreads;

// The shared-memory plan of a type. A stage is 64 bytes of k (16 f32
// or 32 bf16 channels, two mma k-steps): four landed arrays of the
// tile's rows (s[2p] and s[2p+1] of x, then of the residual) and the W
// tile; kStages of them in a cp.async ring. Then the A slab, the kept
// s[2p] and s[2p+1] of the own columns, the (n, p) of each tile row and
// the tap offsets.
template <typename T>
struct Plan {
  static constexpr int kE = 16 / sizeof(T);       // elements a 16-byte chunk
  static constexpr int kKBytes = 64;
  static constexpr int kKE = kKBytes / sizeof(T);  // k elements a stage
  static constexpr int kKSteps = kKBytes / 32;
  static constexpr int kKChunks = kKBytes / 16;
  static constexpr int kPitch = kKBytes + 16;     // a padded A or W row
  static constexpr int kStages = sizeof(T) == 4 ? 2 : 3;
  static constexpr int kLand = kBM * kKBytes;     // one landed array
  static constexpr int kStage = 4 * kLand + kBN * kPitch;
  static constexpr int kRowBytes = kBN * sizeof(T);  // a kept or output row
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kA = kStages * kStage;
  static constexpr int kS0 = kA + kBM * kPitch;
  static constexpr int kS1 = kS0 + kBM * kRowBytes;
  static constexpr int kRowInfo = kS1 + kBM * kRowBytes;
  static constexpr int kOffs = kRowInfo + kBM * 8;
  static constexpr int kSmem = kOffs + svdd::kMaxTaps * 4;
  static constexpr int kLoadRows = kBM * kKChunks / kThreads;  // rows a thread lands
  static_assert(kLoadRows * kThreads == kBM * kKChunks, "whole rows a thread");
  static_assert(kSmem <= 232448, "one block an SM");
};

// byte offset of 16-byte chunk j of kept row q: chunks XOR-swizzled by
// the row, so the epilogue's 8 rows of a fragment fall on distinct banks
template <typename T>
__device__ __forceinline__ int kept(int q, int j) {
  return q * Plan<T>::kRowBytes + ((j ^ (q & 7)) << 4);
}

__device__ __forceinline__ void store_stream16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <typename T, bool IM2COL, bool HAS_RES>
__global__ void __launch_bounds__(kThreads, 1)
    attn_pool_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const T* __restrict__ wt, const float* __restrict__ scale,
                     const float* __restrict__ shift, T* __restrict__ out,
                     svdd::Taps taps, int k_live, int act, int N, int L, int C) {
  using P = Plan<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lh = (L + 1) / 2;
  const long long rows = static_cast<long long>(N) * lh;
  long long m0;
  int n0;
  conv::tile_origin(C, &m0, &n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const uint32_t base = mma::smem_u32(smem);
  int2* row_np = reinterpret_cast<int2*>(smem + P::kRowInfo);  // n < 0: past the end
  int* offs = reinterpret_cast<int*>(smem + P::kOffs);
  if (tid < kBM) {
    const long long r = m0 + tid;
    int2 v = make_int2(-1, 0);
    if (r < rows) {
      const long long n = r / lh;
      v = make_int2(static_cast<int>(n), static_cast<int>(r - n * lh));
    }
    row_np[tid] = v;
  } else if (IM2COL && tid - kBM < k_live) {
    offs[tid - kBM] = taps.off[tid - kBM];
  }
  __syncthreads();

  // this thread lands 16-byte chunk h of tile rows lq[j] in every array
  const int h = tid % P::kKChunks;
  int lq[P::kLoadRows];
  size_t src0[P::kLoadRows];  // x[n, 2p, h * kE]
  bool in0[P::kLoadRows], in1[P::kLoadRows];
#pragma unroll
  for (int j = 0; j < P::kLoadRows; ++j) {
    lq[j] = tid / P::kKChunks + j * (kThreads / P::kKChunks);
    const int2 np = row_np[lq[j]];
    in0[j] = np.x >= 0;
    in1[j] = in0[j] && 2 * np.y + 1 < L;
    src0[j] = in0[j] ? (static_cast<size_t>(np.x) * L + 2 * np.y) * C + h * P::kE : 0;
  }

  auto load = [&](int s) {
    const int k0 = s * P::kKE;
    const uint32_t st = base + (s % P::kStages) * P::kStage;
#pragma unroll
    for (int j = 0; j < P::kLoadRows; ++j) {
      const uint32_t at = st + lq[j] * P::kKBytes + h * 16;
      const size_t i = src0[j] + k0;
      mma::cp_async16(at, in0[j] ? x + i : x, in0[j]);
      mma::cp_async16(at + P::kLand, in1[j] ? x + i + C : x, in1[j]);
      if (HAS_RES) {
        mma::cp_async16(at + 2 * P::kLand, in0[j] ? res + i : res, in0[j]);
        mma::cp_async16(at + 3 * P::kLand, in1[j] ? res + i + C : res, in1[j]);
      }
    }
    const T* wk = wt + static_cast<size_t>(n0) * C + k0;
    for (int e = tid; e < kBN * P::kKChunks; e += kThreads) {
      const int n = e / P::kKChunks, c = e % P::kKChunks;
      mma::cp_async16(st + 4 * P::kLand + n * P::kPitch + c * 16,
                      wk + static_cast<size_t>(n) * C + c * P::kE, true);
    }
  };

  // the landed stage s -> T(d) in the A slab, and s[2p], s[2p+1] kept
  // where its channels are the block's own columns
  auto pass = [&](int s) {
    const int k0 = s * P::kKE;
    const unsigned char* st = smem + (s % P::kStages) * P::kStage;
    const bool own = k0 >= n0 && k0 < n0 + kBN;
#pragma unroll
    for (int j = 0; j < P::kLoadRows; ++j) {
      const int at = lq[j] * P::kKBytes + h * 16;
      uint4 u0 = *reinterpret_cast<const uint4*>(st + at);
      uint4 u1 = *reinterpret_cast<const uint4*>(st + P::kLand + at);
      T* e0 = reinterpret_cast<T*>(&u0);
      T* e1 = reinterpret_cast<T*>(&u1);
      uint4 ud;
      T* ed = reinterpret_cast<T*>(&ud);
      if (HAS_RES) {
        const uint4 v0 = *reinterpret_cast<const uint4*>(st + 2 * P::kLand + at);
        const uint4 v1 = *reinterpret_cast<const uint4*>(st + 3 * P::kLand + at);
        const T* f0 = reinterpret_cast<const T*>(&v0);
        const T* f1 = reinterpret_cast<const T*>(&v1);
#pragma unroll
        for (int e = 0; e < P::kE; ++e) {
          e0[e] = svdd::from_f<T>(svdd::to_f(e0[e]) + svdd::to_f(f0[e]));
          e1[e] = svdd::from_f<T>(svdd::to_f(e1[e]) + svdd::to_f(f1[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < P::kE; ++e)
        ed[e] = svdd::from_f<T>(svdd::to_f(e0[e]) - svdd::to_f(e1[e]));
      *reinterpret_cast<uint4*>(smem + P::kA + lq[j] * P::kPitch + h * 16) = ud;
      if (own) {
        const int c = (k0 - n0) / P::kE + h;
        *reinterpret_cast<uint4*>(smem + P::kS0 + kept<T>(lq[j], c)) = u0;
        *reinterpret_cast<uint4*>(smem + P::kS1 + kept<T>(lq[j], c)) = u1;
      }
    }
  };

  float acc[kMT][kNT][4];
  conv::zero_tile(acc);
  const int n_stages = C / P::kKE;
  for (int s = 0; s < P::kStages - 1; ++s) {
    if (s < n_stages) load(s);
    mma::cp_async_commit();
  }
  // ldmatrix rows of this lane: A, row ra of each m16 tile at 16-byte
  // chunk ac; W, row bn (+ 16 per pair of n8 tiles) at chunk bc
  const int ra = ((lane >> 3) & 1) * 8 + (lane & 7), ac = lane >> 4;
  const int bn = 32 * wn + (lane >> 4) * 8 + (lane & 7), bc = (lane >> 3) & 1;
  uint32_t a_row[kMT];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
    a_row[mi] = base + P::kA + (64 * wm + 16 * mi + ra) * P::kPitch + ac * 16;

#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    mma::cp_async_wait<P::kStages - 2>();
    __syncthreads();  // stage s landed; the A slab and stage s - 1 consumed
    if (s + P::kStages - 1 < n_stages) load(s + P::kStages - 1);
    mma::cp_async_commit();
    pass(s);
    __syncthreads();  // the A slab written
    const uint32_t b_row = base + (s % P::kStages) * P::kStage + 4 * P::kLand +
                           bn * P::kPitch + bc * 16;
    if constexpr (sizeof(T) == 4) {  // a partial sum a stage, flushed
      float part[kMT][kNT][4];
      conv::zero_tile(part);
      conv::mma_stage<T, P::kKSteps, P::kPitch>(a_row, b_row, part);
      conv::add_tile(acc, part);
    } else {
      conv::mma_stage<T, P::kKSteps, P::kPitch>(a_row, b_row, acc);
    }
  }

  // the blend (and the affine and activation) of this thread's
  // accumulators, rounded to T over its own kept s[2p]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = 64 * wm + 16 * mi + g + 8 * hh;
      const int2 np = row_np[q];
      if (np.x < 0) continue;
      const bool tail = (L & 1) && np.y == lh - 1;  // pools alone, weight 1
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int col = 32 * wn + 8 * ni + 2 * t;
        const int at = kept<T>(q, col / P::kE) + (col % P::kE) * sizeof(T);
        T* y = reinterpret_cast<T*>(smem + P::kS0 + at);
        const T* s1 = reinterpret_cast<const T*>(smem + P::kS1 + at);
        float2 sc = make_float2(1.f, 1.f), sh = make_float2(0.f, 0.f);
        if (IM2COL) {
          sc = *reinterpret_cast<const float2*>(scale + n0 + col);
          sh = *reinterpret_cast<const float2*>(shift + n0 + col);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = svdd::to_f(y[e]), b = svdd::to_f(s1[e]);
          const float d = a - b;
          const float wgt = tail ? 1.f : svdd::sigmoid(acc[mi][ni][2 * hh + e]);
          float v = __fadd_rn(b, __fmul_rn(d, wgt));
          if (IM2COL)
            v = svdd::activate(act, __fadd_rn(__fmul_rn(v, e ? sc.y : sc.x),
                                              e ? sh.y : sh.x));
          y[e] = svdd::from_f<T>(v);
        }
      }
    }
  __syncthreads();

  // the staged tile out in 16-byte chunks along each row
  if (!IM2COL) {
    for (int e = tid; e < kBM * P::kRowChunks; e += kThreads) {
      const int q = e / P::kRowChunks, c = e % P::kRowChunks;
      if (row_np[q].x < 0) continue;
      store_stream16(out + (m0 + q) * C + n0 + c * P::kE,
                     *reinterpret_cast<const uint4*>(smem + P::kS0 + kept<T>(q, c)));
    }
  } else {
    const long long kc = static_cast<long long>(k_live) * C;
    for (int e = tid; e < kBM * k_live * P::kRowChunks; e += kThreads) {
      const int c = e % P::kRowChunks, qt = e / P::kRowChunks;
      const int q = qt / k_live, tap = qt - q * k_live;
      const int2 np = row_np[q];
      if (np.x < 0) continue;
      const int off = offs[tap];
      const long long r = m0 + q;
      T* seg = out + tap * C + n0 + c * P::kE;
      const int dst = np.y - off;  // the cols row that reads this pooled row
      if (dst >= 0 && dst < lh)
        store_stream16(seg + (r - off) * kc,
                       *reinterpret_cast<const uint4*>(smem + P::kS0 + kept<T>(q, c)));
      const int src = np.y + off;  // this cols row reads outside: zero
      if (src < 0 || src >= lh) store_stream16(seg + r * kc, make_uint4(0u, 0u, 0u, 0u));
    }
  }
}

template <typename T, bool IM2COL>
int launch(const void* x, const void* res, const void* wt, const void* scale,
           const void* shift, void* out, const int* offsets, int k_live,
           int act, int n, int l, int c, cudaStream_t stream) {
  const long long blocks = conv::grid_blocks(static_cast<long long>(n) * ((l + 1) / 2), c);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = res ? attn_pool_kernel<T, IM2COL, true> : attn_pool_kernel<T, IM2COL, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<T>::kSmem);
  if (e != cudaSuccess) return e;
  const svdd::Taps taps = svdd::make_taps(offsets, k_live);
  kernel<<<static_cast<unsigned>(blocks), kThreads, Plan<T>::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), taps, k_live, act, n, l, c);
  return cudaGetLastError();
}

bool bad_shape(int n, int l, int c) {
  return n < 1 || l < 1 || c < kBN || c % kBN;
}

}  // namespace

// x, residual (nullable) (N, L, C) and wt = W^T (C, C) in the activation
// type, all 16-byte aligned; out (N, ceil(L/2), C); C a multiple of 128.
// dtype: 0 float32, 1 bfloat16.
extern "C" int svdd_attn_pool(const void* x, const void* res, const void* wt,
                              void* out, int n, int l, int c, int dtype,
                              void* stream) {
  if (bad_shape(n, l, c)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(x, res, wt, nullptr, nullptr, out, nullptr, 0, 0, n, l, c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, res, wt, nullptr, nullptr, out, nullptr, 0, 0, n,
                                        l, c, s);
  return cudaErrorInvalidValue;
}

// As svdd_attn_pool, then y = act(pooled * scale + shift) (scale, shift
// (C,) f32, 16-byte aligned) written as im2col slabs: out (N, ceil(L/2), k_live*C);
// offsets (k_live,) host ints, the live tap offsets at the pooled length.
extern "C" int svdd_attn_pool_im2col(const void* x, const void* res,
                                     const void* wt, const void* scale,
                                     const void* shift, void* out,
                                     const void* offsets, int k_live, int act,
                                     int n, int l, int c, int dtype,
                                     void* stream) {
  if (bad_shape(n, l, c) || k_live < 1 || k_live > svdd::kMaxTaps)
    return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(x, res, wt, scale, shift, out, offs, k_live, act, n, l, c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(x, res, wt, scale, shift, out, offs, k_live, act, n, l,
                                       c, s);
  return cudaErrorInvalidValue;
}
