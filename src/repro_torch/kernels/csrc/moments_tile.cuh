// Weighted-moment tile math with a fixed accumulation order.
//
// Replaces the (bB, bn) @ (bn, bd) MXU dots of the TPU kernels
// (repro/kernels/weighted_stats/kernel.py: _fpm_kernel;
// repro/kernels/fused_multi/kernel.py: _fm_kernel moments slot).
//
// No float atomics: each thread folds its columns in column order, a CTA
// sums its threads with a fixed butterfly and then its warps in warp
// order, and writes one partial per (row, column range).  A second pass
// adds the partials of each row in range order.  The ranges depend on the
// shapes only, so repeated runs, and a moments slot of the multi kernel
// against the dedicated moments kernel, are bitwise equal.
#pragma once

#include <cuda_runtime.h>

namespace earl {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;   // rows of W per CTA
constexpr int kDimChunk = 4;  // columns of x per CTA (grid z covers the rest)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums `v` over the CTA in a fixed order; the total is valid in thread 0.
// `red` is kWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += red[w];
  }
  __syncthreads();
  return total;
}

// partial[b, range, q] for b < Bp, summed over ranges in order in Acc and
// rounded to f32 once.  The total weight w_tot uses Acc = double: its
// partials are whole numbers below 2^24 (a CTA covers at most 1024 * 512
// columns of weights <= 10), so the double sum is exact and w_tot is the
// exact total rounded once, as the plain version computes it.  An f32 sum
// would round, in an order of its own, once the total passes 2^24.
template <typename Acc>
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ out, int rows, int ranges,
                             int inner) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * inner) return;
  const int b = idx / inner, q = idx - b * inner;
  Acc s = 0;
  for (int r = 0; r < ranges; ++r) {
    s += part[(static_cast<int64_t>(b) * ranges + r) * inner + q];
  }
  out[idx] = static_cast<float>(s);
}

}  // namespace earl
