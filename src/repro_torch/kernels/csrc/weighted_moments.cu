// Weighted moments of an explicit weight matrix: W (B, n) against x (n, d)
// gives w_tot = ΣW (B,), s1 = W·x and s2 = W·x² (B, d).
//
// Replaces the TPU kernel repro/kernels/weighted_stats/kernel.py:
// weighted_moments_kernel (_ws_kernel), which contracts (bB, bn) tiles of W
// with X and X² on the MXU.
//
// Bound: reading W, B·n·4 bytes (1.07 GB at B = 256, n = 2^20 + 37, 0.32 ms
// at 3.35 TB/s); its 2·B·n·(2d+1) f32 operations take a thirteenth of that
// at d = 1.  So the design spends nothing on the arithmetic and all on
// streaming W: each weight is read once, by one thread, with neighbouring
// threads on neighbouring columns of a row (coalesced), and a thread keeps
// one load per row of its CTA (up to 8) in flight.  x is read once per
// block of rows and serves all of them from registers.
//
// A fixed order and no float atomics (as moments_tile.cuh): a thread folds
// its columns in column order; a CTA sums each accumulator over a warp by
// butterfly and then over warps in warp order, and writes one partial per
// (row, column range); the partials of a row are summed in range order in
// double and rounded once.  The ranges depend on the shapes only, so
// repeated runs are bitwise equal, and w_tot of whole-number weights is
// their exact total.
//
// Grid: x = column ranges of `cols` columns, y = blocks of `rows` rows of
// W, z = chunks of kDimChunk columns of x (only z == 0 does w_tot).
#include <cstdint>
#include <cuda_runtime.h>

#include "moments_tile.cuh"

namespace earl {

constexpr int kAccs = 2 * kDimChunk + 1;  // w, kDimChunk of s1, of s2

struct MomentsParams {
  int B, n, d;
  const float* w;  // (B, n)
  const float* x;  // (n, d)
  int rows, cols, ranges;
  float* part_w;   // (B, ranges)
  float* part_s1;  // (B, ranges, d)
  float* part_s2;  // (B, ranges, d)
};

__global__ void __launch_bounds__(kThreads)
weighted_moments_kernel(MomentsParams p) {
  __shared__ float red[kWarps][kMaxRows * kAccs];
  const int range = blockIdx.x;
  const int r0 = blockIdx.y * p.rows;
  const int dz = blockIdx.z * kDimChunk;
  const int nrows = min(p.rows, p.B - r0);
  const int64_t c0 = static_cast<int64_t>(range) * p.cols;
  const int64_t c1 =
      c0 + p.cols < p.n ? c0 + p.cols : static_cast<int64_t>(p.n);

  float acc_w[kMaxRows];
  float acc_s1[kMaxRows][kDimChunk];
  float acc_s2[kMaxRows][kDimChunk];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    acc_w[r] = 0.f;
#pragma unroll
    for (int q = 0; q < kDimChunk; ++q) acc_s1[r][q] = acc_s2[r][q] = 0.f;
  }

  for (int64_t j = c0 + threadIdx.x; j < c1; j += kThreads) {
    float w[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      w[r] = r < nrows ? __ldg(p.w + static_cast<int64_t>(r0 + r) * p.n + j)
                       : 0.f;
    }
    float xv[kDimChunk], x2[kDimChunk];
#pragma unroll
    for (int q = 0; q < kDimChunk; ++q) {
      xv[q] = dz + q < p.d ? __ldg(p.x + j * p.d + dz + q) : 0.f;
      x2[q] = __fmul_rn(xv[q], xv[q]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      acc_w[r] = __fadd_rn(acc_w[r], w[r]);
#pragma unroll
      for (int q = 0; q < kDimChunk; ++q) {
        acc_s1[r][q] = __fmaf_rn(w[r], xv[q], acc_s1[r][q]);
        acc_s2[r][q] = __fmaf_rn(w[r], x2[q], acc_s2[r][q]);
      }
    }
  }

  // Every accumulator over the warp by butterfly, then one thread per
  // (row, accumulator) sums the warps in warp order: block_sum's order,
  // with one barrier for all of them.
  const int warp = threadIdx.x >> 5;
  const bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const float tw = warp_sum(acc_w[r]);
    if (lane0) red[warp][r * kAccs] = tw;
#pragma unroll
    for (int q = 0; q < kDimChunk; ++q) {
      const float t1 = warp_sum(acc_s1[r][q]);
      const float t2 = warp_sum(acc_s2[r][q]);
      if (lane0) {
        red[warp][r * kAccs + 1 + q] = t1;
        red[warp][r * kAccs + 1 + kDimChunk + q] = t2;
      }
    }
  }
  __syncthreads();
  const int e = threadIdx.x;
  if (e < nrows * kAccs) {
    float total = 0.f;
    for (int v = 0; v < kWarps; ++v) total += red[v][e];
    const int r = e / kAccs, a = e - r * kAccs;
    const int64_t slot = static_cast<int64_t>(r0 + r) * p.ranges + range;
    if (a == 0) {
      if (blockIdx.z == 0) p.part_w[slot] = total;
    } else if (a <= kDimChunk) {
      if (dz + a - 1 < p.d) p.part_s1[slot * p.d + dz + a - 1] = total;
    } else {
      const int q = a - 1 - kDimChunk;
      if (dz + q < p.d) p.part_s2[slot * p.d + dz + q] = total;
    }
  }
}

}  // namespace earl

// Launches the pass and the in-order double sums of its partials; returns
// cudaGetLastError() after the launches.
extern "C" int earl_weighted_moments(int B, int n, int d, const void* w,
                                     const void* x, int rows, int cols,
                                     int ranges, void* part_w, void* part_s1,
                                     void* part_s2, void* w_tot, void* s1,
                                     void* s2, void* stream) {
  if (rows < 1 || rows > earl::kMaxRows || cols < 1 || ranges < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::MomentsParams p{};
  p.B = B; p.n = n; p.d = d;
  p.w = static_cast<const float*>(w);
  p.x = static_cast<const float*>(x);
  p.rows = rows; p.cols = cols; p.ranges = ranges;
  p.part_w = static_cast<float*>(part_w);
  p.part_s1 = static_cast<float*>(part_s1);
  p.part_s2 = static_cast<float*>(part_s2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(ranges, (B + rows - 1) / rows,
            (d + earl::kDimChunk - 1) / earl::kDimChunk);
  earl::weighted_moments_kernel<<<grid, earl::kThreads, 0, s>>>(p);
  const int t = 256;
  earl::sum_partials<double><<<(B + t - 1) / t, t, 0, s>>>(
      p.part_w, static_cast<float*>(w_tot), B, ranges, 1);
  const int nd = B * d;
  earl::sum_partials<double><<<(nd + t - 1) / t, t, 0, s>>>(
      p.part_s1, static_cast<float*>(s1), B, ranges, d);
  earl::sum_partials<double><<<(nd + t - 1) / t, t, 0, s>>>(
      p.part_s2, static_cast<float*>(s2), B, ranges, d);
  return static_cast<int>(cudaGetLastError());
}
