// Warp-level tensor-core pieces of the CNN layer kernels (B1, B6):
// 16-byte cp.async, ldmatrix and mma.sync in bf16 (m16n8k16) and tf32
// (m16n8k8), and the big/small split of an f32 operand for 3xTF32. The
// same instructions as B12 (flash_attention.cu, which keeps its own
// copies).
//
// Fragment layouts (g = lane / 4, t = lane % 4), per PTX's mma docs:
//  * accumulator of an m16n8 tile: d0, d1 at (row g, cols 2t, 2t+1),
//    d2, d3 at (row g + 8, the same cols);
//  * bf16 m16n8k16: a0 (row g, k 2t..2t+1), a1 (row g+8, same k),
//    a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..); b0 (k 2t..2t+1,
//    col g), b1 (k 2t+8.., col g);
//  * tf32 m16n8k8: a0 (row g, k t), a1 (row g+8, k t), a2 (row g,
//    k t+4), a3 (row g+8, k t+4); b0 (k t, col g), b1 (k t+4, col g).
// ldmatrix.x4 reads four 8x8 matrices of 16-bit elements (8 rows of 16
// bytes each, one row address per lane, lanes 8j..8j+7 for matrix j);
// lane l receives row l / 4, 32-bit word l % 4 of each matrix, or with
// .trans the transposed pair (rows 2(l%4), 2(l%4)+1 of column l / 4).
// A 16-byte row of f32 is four 32-bit words, so the non-transposed
// ldmatrix also reads tf32 fragments whose k runs along the row.
#pragma once

#include "common.cuh"

namespace svdd {
namespace mma {

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

// x = big + small: big is x rounded to tf32's 10 mantissa bits (half an
// ulp added, the low 13 bits cleared), small = x - big, exact in f32
// with |small| <= 2^-11 |x|. The tensor core reads a tf32 operand's top
// 19 bits, so small, passed as it is, loses under 2^-10 of itself: 2^-21
// of x, as does the dropped small.small term. 3xTF32 sums small.big +
// big.small + big.big: about 2^-20 of |a||b| a product.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}

}  // namespace mma
}  // namespace svdd
