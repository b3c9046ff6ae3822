// The deterministic second pass over per-block partial sums, shared by
// the backward kernels (B6 cnn_layer_bwd.cu, B7 conv1d_bwd.cu, B8
// attn_pool_bwd.cu through gemm.cuh): the TPU kernels carried such sums
// in an accumulator across their sequential grid; blocks on the card run
// in parallel, so each writes a partial and this pass adds them.
#pragma once

#include "common.cuh"

namespace svdd {

// out[b, e] = sum_{p < parts} in[b, p, e]: the deterministic second pass
// over per-block partials (blocks run in parallel on the card, so a sum
// across them needs a pass of its own; float atomics would change the
// result from run to run). A block of 256 threads is rows x cols: rows
// is the least power of two >= parts, at most 32, so few outputs over
// many parts (the per-channel sums of a whole batch) run up to 32 chains
// per output, and many outputs over a few parts (a weight gradient of a
// few row chunks) leave no thread idle. Thread row r sums parts r,
// r + rows, ... in order; row 0 then adds the row sums in order, so the
// result depends only on the shapes.
constexpr int kRedThreads = 256, kRedMaxRows = 32;

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

inline cudaError_t reduce_partials(const float* in, float* out, int batches,
                                   int parts, long long elems,
                                   cudaStream_t stream) {
  int rows = 1;
  while (rows < parts && rows < kRedMaxRows) rows *= 2;
  const int cols = kRedThreads / rows;
  const long long total = static_cast<long long>(batches) * elems;
  reduce_partials_kernel<<<static_cast<unsigned>((total + cols - 1) / cols),
                           dim3(cols, rows), 0, stream>>>(in, out, batches,
                                                          parts, elems);
  return cudaGetLastError();
}

}  // namespace svdd
