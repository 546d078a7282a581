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

#include <cstdint>
#include <cuda_runtime.h>

namespace earl {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;   // rows of W per CTA
constexpr int kDimChunk = 4;  // columns of x per CTA (grid z covers the rest)

// Columns of x a fused moments CTA sums, DC: 1, 2 or 4 (kDimChunk), the
// least power of two that covers d up to 4 (_pass.dim_chunk).
// DC < kDimChunk only where d <= 2, where one chunk of either covers all
// d columns, so the grid z chunks, and every sum, are unchanged; a thread
// only drops the accumulators of columns past d.
inline int dim_chunk(int d) { return d <= 1 ? 1 : d <= 2 ? 2 : kDimChunk; }

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

// A CTA's partials of rows r0 .. r0+nrows-1 over its column range: the
// block sums of acc_w (only when `lead`, the CTA of z chunk 0) and of the
// chunk's DC columns dz + q < d of acc_s1 and acc_s2, written by thread 0
// at (row, range).  Fully unrolled so the accumulators stay in registers;
// the guards are uniform over the CTA, so every thread reaches every
// __syncthreads.  `red` is kWarps floats of shared memory.
template <int DC>
__device__ __forceinline__ void write_moment_partials(
    const float (&acc_w)[kMaxRows], const float (&acc_s1)[kMaxRows][DC],
    const float (&acc_s2)[kMaxRows][DC], int nrows, int r0, int range,
    int ranges, int dz, int d, bool lead, float* red, float* part_w,
    float* part_s1, float* part_s2) {
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < nrows) {
      const int64_t slot = static_cast<int64_t>(r0 + r) * ranges + range;
      if (lead) {
        const float tw = block_sum(acc_w[r], red);
        if (threadIdx.x == 0) part_w[slot] = tw;
      }
#pragma unroll
      for (int q = 0; q < DC; ++q) {
        if (dz + q < d) {
          const float t1v = block_sum(acc_s1[r][q], red);
          const float t2v = block_sum(acc_s2[r][q], red);
          if (threadIdx.x == 0) {
            part_s1[slot * d + dz + q] = t1v;
            part_s2[slot * d + dz + q] = t2v;
          }
        }
      }
    }
  }
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

// Launches the in-order sums of a fused moments pass's partials over its
// ranges, the order every fused moments kernel shares: w_tot in double
// (exact, rounded once), s1 and s2 in f32.  A row has `wn` entries of
// w_tot (the keys, or 1) and `sn` of s1 and of s2.
inline void sum_fused_partials(const float* part_w, const float* part_s1,
                               const float* part_s2, float* w_tot, float* s1,
                               float* s2, int rows, int ranges, int wn,
                               int sn, cudaStream_t stream) {
  const int t = 256, nw = rows * wn, ns = rows * sn;
  sum_partials<double><<<(nw + t - 1) / t, t, 0, stream>>>(
      part_w, w_tot, rows, ranges, wn);
  sum_partials<float><<<(ns + t - 1) / t, t, 0, stream>>>(
      part_s1, s1, rows, ranges, sn);
  sum_partials<float><<<(ns + t - 1) / t, t, 0, stream>>>(
      part_s2, s2, rows, ranges, sn);
}

}  // namespace earl
