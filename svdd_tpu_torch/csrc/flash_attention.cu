// Multi-head softmax attention of the DiT and AR backbones, optionally
// causal, in one of the two roundings the JAX package's dispatch takes
// on a TPU (svdd_tpu/ops/attention.py:flash_mha):
//   * the Pallas body's (L a multiple of 128, D of 64):
//       out[b, i, h] = sum_j p_ij v[b, j, h] / sum_j p_ij,
//       p_ij = exp(s_ij - max_j s_ij),  s_ij = q[b, i, h] . k[b, j, h] / sqrt(D)
//     with s, the row maxima and the row sums in f32, p rounded to v's
//     type before the p.v product (f32 accumulate), and the division by
//     the f32 row sum at the end;
//   * XLA's mha elsewhere (mha_rounding): out = sum_j P_ij v[b, j, h]
//     with P_ij = p_ij / sum_j p_ij normalised in f32 and then rounded to
//     v's type, so the keys are walked twice: a first pass of q.k alone
//     for each row's maximum and sum, then the p.v pass. Built for bf16
//     alone: in float32 the rounding to v's type does nothing and the two
//     roundings are one function, which the single pass computes.
//
// Replaces svdd_tpu/ops/flash_attention_pallas.py:flash_attention
// (pallas_call :66, body _attn_kernel :31-51), and XLA's mha
// (svdd_tpu/ops/attention.py:28) at the shapes JAX's dispatch sends there.
//
// What bounds it on an H100: operations. A call does 4 L^2 D flops per
// (batch, head) against 4 L D elements moved, some 500 flops per byte
// at L = 1024, D = 64 (the mha rounding adds the first pass's 2 L^2 D
// and a second exponential a score). So both products run on the tensor
// cores, as warp-level mma.sync in the FlashAttention-2 shape:
//   * bf16: m16n8k16 bf16 x bf16 -> f32, the rate the card's bound
//     assumes (989 TFLOP/s);
//   * f32: 3xTF32, m16n8k8 tf32 -> f32. Each operand x is split into
//     a tf32 big part and the rest, small = x - big, and the product
//     summed as small.big + big.small + big.big, each term over all
//     n-tiles before the next, so no mma waits on the one before: about
//     2^-20 of |a||b| a product, near f32, at a third of the TF32 rate
//     (495/3 TFLOP/s) against 67 TFLOP/s for f32 FMAs. This is the scheme
//     of PyTorch's f32 memory-efficient attention (CUTLASS's
//     OpMultiplyAddFastF32). Plain TF32 would keep three decimal digits.
//
// Tile: a block is 4 warps (8 for f32 at D = 128), each over 32 query
// rows as two 16-row m-tiles, and walks the keys in tiles of BN (Shape
// below) with an online softmax: a running row maximum m and row sum l,
// the output rescaled by exp(m_old - m_new) when the maximum grows (in
// the mha rounding the first pass keeps m and l so, and the second
// normalises each p by the final sum before the p.v product). The
// L x L scores never leave registers: s is the accumulator of the q.k
// mma, the softmax runs on it with quad shuffles for the row maxima
// (each row of an accumulator lies in one quad of 4 lanes), and p,
// rounded to v's type in registers, is the A operand of the p.v mma (the
// accumulator layout is the A layout of the next product; in f32 the k
// index is permuted, key 2t -> column t and 2t+1 -> t+4, and v's rows
// the same way). K and V tiles stream through a double-buffered
// shared-memory ring filled by 16-byte cp.async (rows past L
// zero-filled; the first pass of the mha rounding loads K alone), so the
// next tile's loads overlap this tile's products;
// the query tile is loaded the same way once. Fragments are read by
// ldmatrix (.trans for bf16 v). Shared-memory rows are padded by 16
// bytes, which puts the 8 row addresses of every ldmatrix phase on
// distinct banks; f32 v is read by scalar loads at (key 2t, column g),
// bank 8t + g on that padding: no conflicts either. In causal mode the
// key tiles above the diagonal are skipped, a warp skips a tile none of
// its rows may see, only the tiles on the diagonal or past L are masked,
// and the longest query tiles are launched first. q, k and v are read in
// their (B, L, H, D) layout by stride, so the TPU wrapper's three
// transposes are not made.
//
// Rounding: the scores are scaled after the product, in the exp2 domain
// (2^(s * log2(e)/sqrt(D) - m), one fma and one ex2.approx), not the
// TPU's exp(s/sqrt(D) - m): a few f32 ulps of p. In the body's rounding p
// is rounded to v's type against the running maximum, not the row's final
// one: in bf16 that rounding can land one bf16 ulp apart from the TPU
// kernel's for rows whose maximum grows after the first tile (the plain
// form, svdd_tpu_torch/ops/attention.py:attention_body_plain, rounds
// against the final one). The mha rounding normalises by the final sum,
// as 2^(s c - (m + log2 l)) (a few f32 ulps from the quotient, and no
// division), and rounds as svdd_tpu_torch/ops/attention.py:mha does. In
// f32 the
// products carry 3xTF32's ~2^-20 relative error and are summed in
// another order.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small: big is x rounded to tf32's 10 mantissa bits (half
// an ulp added, the low 13 bits cleared), small = x - big, exact in f32
// with |small| <= 2^-11 |x|. The tensor core reads a tf32 operand's top
// 19 bits, so small, passed as it is, loses under 2^-10 of itself: 2^-21
// of x, as does the dropped small.small term.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// 2^x in one MUFU op (2 ulp; results below 2^-126 flush to 0, far
// under a p that is 1 at the row maximum)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// Tile shape of each (type, head dim): warps a block, and keys a K/V
// tile. Every warp holds two 16-row m-tiles, so each k or v fragment
// read from shared memory feeds two mmas; the registers that takes are
// why q is read again from shared memory each tile (as FlashAttention-2
// does) instead of held for the whole loop. Shared memory, (Q + 2 K + 2
// V) rows of D + pad: 92 KB (bf16, D = 64), 104 KB (bf16 at D = 128, f32
// at D = 64; two blocks, 8 warps, an SM), 198 KB (f32 at D = 128, one
// block of 8 warps).
template <typename T, int HD>
struct Shape;
template <>
struct Shape<__nv_bfloat16, 64> { static constexpr int kWarps = 4, kBN = 128; };
template <>
struct Shape<__nv_bfloat16, 128> { static constexpr int kWarps = 4, kBN = 64; };
template <>
struct Shape<float, 64> { static constexpr int kWarps = 4, kBN = 64; };
template <>
struct Shape<float, 128> { static constexpr int kWarps = 8, kBN = 32; };

template <typename T, int HD>
struct Tiles : Shape<T, HD> {
  using S = Shape<T, HD>;
  static constexpr int kM = 2;                       // m-tiles a warp
  static constexpr int kThreads = 32 * S::kWarps;
  static constexpr int kBM = 16 * kM * S::kWarps;    // queries a block
  static constexpr int kE = 16 / sizeof(T);   // elements a 16-byte chunk
  static constexpr int kLd = HD + kE;         // padded shared row
  static constexpr size_t smem_bytes() {
    return static_cast<size_t>(kBM + 4 * S::kBN) * kLd * sizeof(T);
  }
};

// kNorm: the mha rounding, a statistics pass over the keys, then the p.v
// pass on probabilities normalised before they are rounded
template <typename T, int HD, bool kNorm>
__global__ void __launch_bounds__(Tiles<T, HD>::kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int L,
                           int H, int qsb, int qsl, int qsh, int ksb, int ksl,
                           int ksh, int vsb, int vsl, int vsh, float scale_log2,
                           int causal) {
  using TL = Tiles<T, HD>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kBN = TL::kBN, kE = TL::kE, kLd = TL::kLd, kM = TL::kM;
  constexpr int kBM = TL::kBM, kThreads = TL::kThreads;
  constexpr int kRowBytes = kLd * sizeof(T);
  constexpr int kKK = kBf16 ? 16 : 8;   // mma depth
  constexpr int kQSteps = HD / kKK;     // k-steps of q.k
  constexpr int kSTiles = kBN / 8;      // n-tiles of s
  constexpr int kOTiles = HD / 8;       // n-tiles of the output
  constexpr int kChunks = HD / kE;      // 16-byte chunks a row
  static_assert(kSTiles % 2 == 0 && kOTiles % 2 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [kBM][kLd]
  T* Ks = Qs + kBM * kLd;                   // [2][kBN][kLd]
  T* Vs = Ks + 2 * kBN * kLd;               // [2][kBN][kLd]

  const int n_qt = (L + kBM - 1) / kBM;
  // causal: the longest query tiles first, so they do not trail the grid
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * kM * warp;   // the warp's first query row

  const T* qb = q + static_cast<size_t>(b) * qsb + static_cast<size_t>(h) * qsh;
  const T* kb = k + static_cast<size_t>(b) * ksb + static_cast<size_t>(h) * ksh;
  const T* vb = v + static_cast<size_t>(b) * vsb + static_cast<size_t>(h) * vsh;

  // rows row0.. of src into dst, 16 bytes a thread a step
  auto load_tile = [&](T* dst, const T* src, int row0, int rows, int sl) {
    for (int idx = tid; idx < rows * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = row0 + r < L;
      const T* s = in ? src + static_cast<size_t>(row0 + r) * sl + c * kE : src;
      cp_async16(smem_u32(dst + r * kLd + c * kE), s, in);
    }
  };

  const int n_kv = (L + kBN - 1) / kBN;
  const int n_kt = causal ? min(n_kv, (min(q0 + kBM, L) - 1) / kBN + 1) : n_kv;
  // iterations over the key tiles: one pass, or (kNorm) the statistics
  // pass and the p.v pass; the ring's stage alternates across both
  const int n_it = kNorm ? 2 * n_kt : n_kt;

  load_tile(Qs, qb, q0, kBM, qsl);
  load_tile(Ks, kb, 0, kBN, ksl);
  if (!kNorm) load_tile(Vs, vb, 0, kBN, vsl);
  cp_async_commit();

  // ldmatrix row addresses of this lane. q (A operand) and v (B operand,
  // transposed): matrix lane/8 covers rows ((lane/8) & 1) * 8.. and
  // 16-byte column chunk lane/16; k (B operand): rows (lane/16) * 8..,
  // chunk (lane/8) & 1.
  const int ra = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int rb = (lane >> 4) * 8 + (lane & 7);
  const uint32_t q_addr =
      smem_u32(Qs) + (16 * kM * warp + ra) * kRowBytes + (lane >> 4) * 16;
  const uint32_t k_off = rb * kRowBytes + ((lane >> 3) & 1) * 16;
  const uint32_t v_off = ra * kRowBytes + (lane >> 4) * 16;

  // the A fragment of q, m-tile mi, k-step kk (a k-step is 32 bytes of a
  // row in either type); f32 splits it into big and small halves
  auto q_frag = [&](int mi, int kk, uint32_t (&a)[4], uint32_t (&as)[4]) {
    ldsm_x4(a, q_addr + (16 * mi) * kRowBytes + kk * 32);
    if constexpr (!kBf16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(a[j]), a[j], as[j]);
    }
  };

  float o[kM][kOTiles][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int i = 0; i < kOTiles; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[mi][i][j] = 0.f;
  // rows g and g + 8 of each m-tile: the running maximum (log2 domain)
  // and this lane's part of the row sum
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = -INFINITY;
      l[mi][r] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    const int kt = it < n_kt ? it : it - n_kt;
    const bool stats = kNorm && it < n_kt;   // q.k alone: m and l
    const int st = it & 1;
    if (it + 1 < n_it) {
      const int nk = it + 1 < n_kt ? it + 1 : it + 1 - n_kt;
      load_tile(Ks + (st ^ 1) * kBN * kLd, kb, nk * kBN, kBN, ksl);
      if (!kNorm || it + 1 >= n_kt)
        load_tile(Vs + (st ^ 1) * kBN * kLd, vb, nk * kBN, kBN, vsl);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kNorm && it == n_kt) {
      // the statistics pass is done: each row's full sum, folded into
      // its shift, 2^(s c - m) / l = 2^(s c - (m + log2 l)), so the p.v
      // pass normalises with no division
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) m[mi][r] += log2f(quad_sum(l[mi][r]));
    }

    const int k0 = kt * kBN;
    // a warp whose rows all precede the tile's first key skips it
    if (!causal || k0 <= w0 + 16 * kM - 1) {
      const uint32_t k_addr = smem_u32(Ks + st * kBN * kLd) + k_off;
      float s[kM][kSTiles][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int i = 0; i < kSTiles; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[mi][i][j] = 0.f;

      // s = q . k^T
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        uint32_t a[kM][4], as[kM][4];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) q_frag(mi, kk, a[mi], as[mi]);
        if constexpr (kBf16) {
#pragma unroll
          for (int np = 0; np < kSTiles / 2; ++np) {
            uint32_t bb[4];
            ldsm_x4(bb, k_addr + np * 16 * kRowBytes + kk * 32);
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) {
              mma_bf16(s[mi][2 * np], a[mi], bb[0], bb[1]);
              mma_bf16(s[mi][2 * np + 1], a[mi], bb[2], bb[3]);
            }
          }
        } else {
          // 3xTF32, one term at a time over all n-tiles, so that no mma
          // waits on the one just issued
          uint32_t bb[kSTiles][2], bs[kSTiles][2];
#pragma unroll
          for (int np = 0; np < kSTiles / 2; ++np) {
            uint32_t r[4];
            ldsm_x4(r, k_addr + np * 16 * kRowBytes + kk * 32);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              split_tf32(__uint_as_float(r[j]), bb[2 * np + j / 2][j % 2],
                         bs[2 * np + j / 2][j % 2]);
          }
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int i = 0; i < kSTiles; ++i) mma_tf32(s[mi][i], as[mi], bb[i][0], bb[i][1]);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int i = 0; i < kSTiles; ++i) mma_tf32(s[mi][i], a[mi], bs[i][0], bs[i][1]);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int i = 0; i < kSTiles; ++i) mma_tf32(s[mi][i], a[mi], bb[i][0], bb[i][1]);
        }
      }

      // mask only a tile on the diagonal or past L: s[mi][i][j] is row
      // w0 + 16 mi + g + 8 (j / 2), key k0 + 8 i + 2 t + j % 2
      if (k0 + kBN > L || (causal && k0 + kBN - 1 > w0)) {
#pragma unroll
        for (int mi = 0; mi < kM; ++mi)
#pragma unroll
          for (int i = 0; i < kSTiles; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int key = k0 + 8 * i + 2 * t + (j & 1);
              const int row = w0 + 16 * mi + g + 8 * (j >> 1);
              if (key >= L || (causal && key > row)) s[mi][i][j] = -INFINITY;
            }
      }

      if (kNorm && !stats) {
        // p normalised by the final maximum and sum (the shift), then
        // rounded below
#pragma unroll
        for (int mi = 0; mi < kM; ++mi)
#pragma unroll
          for (int i = 0; i < kSTiles; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s[mi][i][j] = exp2_approx(fmaf(s[mi][i][j], scale_log2,
                                             -m[mi][j >> 1]));
      } else {
      // online softmax on the accumulators; tile 0 holds key 0, which
      // every row may attend, so m is finite from the first tile on
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < kSTiles; ++i)
            mx = fmaxf(mx, fmaxf(s[mi][i][2 * r], s[mi][i][2 * r + 1]));
          const float m_new = fmaxf(m[mi][r], quad_max(mx) * scale_log2);
          const float alpha = exp2_approx(m[mi][r] - m_new);
          m[mi][r] = m_new;
          float rs = 0.f;
#pragma unroll
          for (int i = 0; i < kSTiles; ++i)
#pragma unroll
            for (int j = 2 * r; j < 2 * r + 2; ++j) {
              s[mi][i][j] = exp2_approx(fmaf(s[mi][i][j], scale_log2, -m_new));
              rs += s[mi][i][j];
            }
          l[mi][r] = l[mi][r] * alpha + rs;
          if (!kNorm) {
#pragma unroll
            for (int i = 0; i < kOTiles; ++i) {
              o[mi][i][2 * r] *= alpha;
              o[mi][i][2 * r + 1] *= alpha;
            }
          }
        }
      }

      // o += p . v, p rounded to v's type in registers
      const T* vt = Vs + st * kBN * kLd;
      if (stats) {
        // the statistics pass reads no v
      } else if constexpr (kBf16) {
        const uint32_t v_addr = smem_u32(vt) + v_off;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          uint32_t a[kM][4];
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            a[mi][0] = pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
            a[mi][1] = pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
            a[mi][2] = pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
            a[mi][3] = pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
          }
#pragma unroll
          for (int dp = 0; dp < kOTiles / 2; ++dp) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, v_addr + kk * 16 * kRowBytes + dp * 32);
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) {
              mma_bf16(o[mi][2 * dp], a[mi], bb[0], bb[1]);
              mma_bf16(o[mi][2 * dp + 1], a[mi], bb[2], bb[3]);
            }
          }
        }
      } else {
        // k-step kk is s tile kk: this lane holds keys 2t, 2t + 1 of it,
        // fed as mma columns t and t + 4, with v's rows 2t, 2t + 1
#pragma unroll
        for (int kk = 0; kk < kSTiles; ++kk) {
          uint32_t ab[kM][4], as[kM][4];
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            split_tf32(s[mi][kk][0], ab[mi][0], as[mi][0]);
            split_tf32(s[mi][kk][2], ab[mi][1], as[mi][1]);
            split_tf32(s[mi][kk][1], ab[mi][2], as[mi][2]);
            split_tf32(s[mi][kk][3], ab[mi][3], as[mi][3]);
          }
          const float* vr = reinterpret_cast<const float*>(vt) +
                            (8 * kk + 2 * t) * kLd + g;
          uint32_t bb[kOTiles][2], bs[kOTiles][2];
#pragma unroll
          for (int dt = 0; dt < kOTiles; ++dt) {
            split_tf32(vr[8 * dt], bb[dt][0], bs[dt][0]);
            split_tf32(vr[kLd + 8 * dt], bb[dt][1], bs[dt][1]);
          }
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int i = 0; i < kOTiles; ++i) mma_tf32(o[mi][i], as[mi], bb[i][0], bb[i][1]);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int i = 0; i < kOTiles; ++i) mma_tf32(o[mi][i], ab[mi], bs[i][0], bs[i][1]);
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int i = 0; i < kOTiles; ++i) mma_tf32(o[mi][i], ab[mi], bb[i][0], bb[i][1]);
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

  // out is (B, L, H, HD), contiguous; the division by the row sum last
  // (kNorm: p was normalised before the product)
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + 16 * mi + g + 8 * r;
      const float den = kNorm ? 1.f : quad_sum(l[mi][r]);
      if (row >= L) continue;
      T* orow = out + ((static_cast<size_t>(b) * L + row) * H + h) * HD + 2 * t;
#pragma unroll
      for (int i = 0; i < kOTiles; ++i)
        store2(orow + 8 * i, o[mi][i][2 * r] / den, o[mi][i][2 * r + 1] / den);
    }
}

template <typename T, int HD, bool kNorm>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L,
           int H, const int* st, float scale_log2, int causal,
           cudaStream_t stream) {
  using TL = Tiles<T, HD>;
  const size_t smem = TL::smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD, kNorm>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((L + TL::kBM - 1) / TL::kBM, B * H);
  flash_attention_kernel<T, HD, kNorm><<<grid, TL::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), L, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale_log2, causal);
  return cudaGetLastError();
}

// The mha rounding (kNorm) is built for bf16 alone: in float32 v's type
// is f32, so rounding p before or after the normalisation is one
// function, and the single pass computes it (the wrapper takes it for
// float32 at every shape; a float32 call with the flag set is refused).
template <typename T, int HD>
int launch_rounding(const void* q, const void* k, const void* v, void* out,
                    int B, int L, int H, const int* st, float scale_log2,
                    int causal, int mha_rounding, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mha_rounding)
      return launch<T, HD, true>(q, k, v, out, B, L, H, st, scale_log2, causal,
                                 s);
  } else {
    if (mha_rounding) return cudaErrorInvalidValue;
  }
  return launch<T, HD, false>(q, k, v, out, B, L, H, st, scale_log2, causal, s);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int L,
             int H, int D, const int* st, float scale_log2, int causal,
             int mha_rounding, cudaStream_t s) {
  // 16-byte cp.async: every row start 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (bases % 16) return cudaErrorMisalignedAddress;
  for (int i = 0; i < 9; ++i)
    if (st[i] % static_cast<int>(16 / sizeof(T))) return cudaErrorMisalignedAddress;
  // the head dims built: the presets' 64 and 128 (e.g. the text preset
  // at 6 heads); any other D is refused here and by the wrapper
  if (D == 64)
    return launch_rounding<T, 64>(q, k, v, out, B, L, H, st, scale_log2, causal,
                                  mha_rounding, s);
  if (D == 128)
    return launch_rounding<T, 128>(q, k, v, out, B, L, H, st, scale_log2, causal,
                                   mha_rounding, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v (B, L, H, D) in the activation type, each with unit stride
// over D, 16-byte aligned, and element strides (batch, position, head)
// in st[0..2] (q), st[3..5] (k), st[6..8] (v), each a multiple of 16
// bytes; out (B, L, H, D) contiguous in the same type. D is 64 or 128.
// scale: 1/sqrt(D). mha_rounding: 0 the Pallas body's rounding, 1
// XLA mha's (p normalised, then rounded; bfloat16 only). dtype: 0
// float32, 1 bfloat16.
extern "C" int svdd_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int L, int H, int D,
                                    int qsb, int qsl, int qsh, int ksb, int ksl,
                                    int ksh, int vsb, int vsl, int vsh,
                                    float scale, int causal, int mha_rounding,
                                    int dtype, void* stream) {
  // grid.y is B * H, at most 65535
  if (B < 1 || L < 1 || H < 1 || static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;
  const int st[9] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, L, H, D, st, scale_log2, causal,
                           mha_rounding, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, L, H, D, st, scale_log2,
                                   causal, mha_rounding, s);
  return cudaErrorInvalidValue;
}
