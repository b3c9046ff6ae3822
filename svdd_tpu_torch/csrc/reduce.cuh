// The deterministic second pass over per-block partial sums, shared by
// the backward kernels (B6 cnn_layer_bwd.cu, B7 conv1d_bwd.cu, B8
// attn_pool_bwd.cu): the TPU kernels carried such sums in an accumulator
// across their sequential grid; blocks on the card run in parallel, so
// each writes a partial and this pass adds them.
#pragma once

#include "common.cuh"

namespace svdd {

// out[b, e] = sum_{p < parts} in[b, p, e]: the deterministic second pass
// over per-block partials (blocks run in parallel on the card, so a sum
// across them needs a pass of its own; float atomics would change the
// result from run to run). Two kernels, by the shape of the sum, each
// adding in an order that depends only on the shapes:
//  * reduce_partials_vec4_kernel, for many outputs (a weight gradient's
//    partials: elems a multiple of 4, at least red_vec_outputs()
//    outputs, two blocks an SM of the card, 16-byte aligned): a thread
//    per 4 consecutive outputs adds the parts in order, p = 0, 1, ...,
//    with 16-byte loads that do not wait on each other, so many are in
//    flight. Over B8's partials, 258 MB at
//    the classifier's seven pools, it took 0.10 ms where the kernel
//    below, one 4-byte load a thread in flight, took 0.46 ms on an H100
//    (scripts/probe_attn_pool_bwd.py, variant reduce_strided);
//  * reduce_partials_kernel, for the rest (few outputs over many parts,
//    the per-channel sums of a whole batch): a block of 256 threads is
//    rows x cols, rows the least power of two >= parts, at most 32, so
//    up to 32 chains run per output; thread row r sums parts r, r +
//    rows, ... in order, and row 0 then adds the row sums in order.
constexpr int kRedThreads = 256, kRedMaxRows = 32;
inline long long red_vec_outputs() { return 4LL * 2 * sm_count() * kRedThreads; }

__global__ void reduce_partials_kernel(const float* __restrict__ in,
                                       float* __restrict__ out, int batches,
                                       int parts, long long elems) {
  __shared__ float red[kRedThreads + kRedMaxRows];
  const int cols = blockDim.x, rows = blockDim.y;
  const long long total = static_cast<long long>(batches) * elems;
  const long long i = static_cast<long long>(blockIdx.x) * cols + threadIdx.x;
  float s = 0.f;
  if (i < total) {
    const long long b = i / elems, e = i - b * elems;
    const float* src = in + b * parts * elems + e;
    for (int p = threadIdx.y; p < parts; p += rows) s += src[p * elems];
  }
  red[threadIdx.y * (cols + 1) + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < total) {
    float t = 0.f;
    for (int r = 0; r < rows; ++r) t += red[r * (cols + 1) + threadIdx.x];
    out[i] = t;
  }
}

__global__ void reduce_partials_vec4_kernel(const float4* __restrict__ in,
                                            float4* __restrict__ out, int batches,
                                            int parts, long long elems4) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batches * elems4) return;
  const long long b = i / elems4, e = i - b * elems4;
  const float4* src = in + b * parts * elems4 + e;
  float4 s = src[0];
#pragma unroll 4
  for (int p = 1; p < parts; ++p) {
    const float4 v = src[p * elems4];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

inline cudaError_t reduce_partials(const float* in, float* out, int batches,
                                   int parts, long long elems,
                                   cudaStream_t stream) {
  const long long total = static_cast<long long>(batches) * elems;
  if (elems % 4 == 0 && total >= red_vec_outputs() &&
      reinterpret_cast<uintptr_t>(in) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    reduce_partials_vec4_kernel<<<static_cast<unsigned>((total / 4 + kRedThreads - 1) / kRedThreads),
                                  kRedThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), batches, parts,
        elems / 4);
    return cudaGetLastError();
  }
  int rows = 1;
  while (rows < parts && rows < kRedMaxRows) rows *= 2;
  const int cols = kRedThreads / rows;
  reduce_partials_kernel<<<static_cast<unsigned>((total + cols - 1) / cols),
                           dim3(cols, rows), 0, stream>>>(in, out, batches,
                                                          parts, elems);
  return cudaGetLastError();
}

}  // namespace svdd
