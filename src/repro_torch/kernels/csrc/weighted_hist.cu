// Weighted histogram sketch of explicit weights: x (n, d) under R rows of
// weights W (R, n) gives counts (R, d, nbins); a null W is one row of unit
// weights (a point estimate).  Values are binned by bin_index
// (hist_tile.cuh): out-of-range values and +-inf clip to the edge bins,
// NaN carries no mass.
//
// Replaces the TPU kernel repro/kernels/weighted_hist/kernel.py:
// weighted_hist_kernel (_wh_kernel), which builds a (bn, bd, nbins) one-hot
// in VMEM and contracts it with the (bn, 1) weights.  Here each nonzero
// weight lands in its bin with one shared-memory atomic add.
//
// Bound: reading W, R·n·4 bytes (0.32 ms at R = 256, n = 2^20 + 37), or at
// R = 1 without W reading x (0.02 ms at n = 2^24 − 1000).  A CTA takes up to
// 8 rows of W, a range of columns and a chunk of `dc` dimensions: it reads
// each weight once per chunk (coalesced across the warp), bins each value
// of its dimensions once for all its rows, and keeps rows·dc·nbins bins in
// shared memory, added to the output once at the end.  Fewer rows a CTA
// (d·nbins large) mean x is binned more often; past one row's d·nbins bins
// in an SM's shared memory the wrapper cuts the dimensions into chunks
// (grid z), each reading W again.
//
// Counts of whole-number weights are exact in f32 below 2^24 a bin, in any
// order of the atomics, so they are bitwise the plain version's and repeat
// bitwise; sums of fractional weights round in the atomics' order, which
// changes from run to run.
//
// Grid: x = column ranges of `cols` columns, y = blocks of `rows` rows,
// z = chunks of `dc` dimensions.
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"
#include "moments_tile.cuh"

namespace earl {

struct HistParams {
  int R, n, d, nbins;
  int dc;           // dimensions a CTA
  const float* x;   // (n, d)
  const float* w;   // (R, n), or nullptr: one row of unit weights
  const float* lo;  // (d)
  const float* hi;  // (d)
  int rows, cols, ranges;
  float* out;       // (R, d * nbins), zeroed
};

__global__ void __launch_bounds__(kThreads)
weighted_hist_kernel(HistParams p) {
  extern __shared__ __align__(16) float bins[];
  const int total = p.d * p.nbins;
  const int d0 = blockIdx.z * p.dc;
  const int dn = min(p.dc, p.d - d0);
  const int len = dn * p.nbins;  // the CTA's bins a row
  const int r0 = blockIdx.y * p.rows;
  const int nrows = min(p.rows, p.R - r0);
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * p.cols;
  const int64_t c1 =
      c0 + p.cols < p.n ? c0 + p.cols : static_cast<int64_t>(p.n);

  for (int e = threadIdx.x; e < nrows * len; e += blockDim.x) bins[e] = 0.f;
  __syncthreads();

  for (int64_t j = c0 + threadIdx.x; j < c1; j += kThreads) {
    float w[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      w[r] = r >= nrows ? 0.f
             : p.w != nullptr
                 ? __ldg(p.w + static_cast<int64_t>(r0 + r) * p.n + j)
                 : 1.f;
    }
    for (int k = 0; k < dn; ++k) {
      const int dd = d0 + k;
      const float xv = __ldg(p.x + j * p.d + dd);
      if (isnan(xv)) continue;  // NaN carries no mass
      float* dst = bins + k * p.nbins +
                   bin_index(xv, __ldg(p.lo + dd), __ldg(p.hi + dd), p.nbins);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (w[r] != 0.f) atomicAdd(dst + r * len, w[r]);
      }
    }
  }
  __syncthreads();
  flush_window(bins, nrows, len, p.out, total, r0, d0 * p.nbins);
}

}  // namespace earl

// Returns cudaGetLastError() after the launch.
extern "C" int earl_weighted_hist(int R, int n, int d, int nbins,
                                  const void* x, const void* w,
                                  const void* lo, const void* hi, int dc,
                                  int rows, int cols, int ranges, void* out,
                                  void* stream) {
  if (rows < 1 || rows > earl::kMaxRows || cols < 1 || ranges < 1 ||
      dc < 1 || dc > d || (w == nullptr && R != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::HistParams p{};
  p.R = R; p.n = n; p.d = d; p.nbins = nbins; p.dc = dc;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.lo = static_cast<const float*>(lo);
  p.hi = static_cast<const float*>(hi);
  p.rows = rows; p.cols = cols; p.ranges = ranges;
  p.out = static_cast<float*>(out);
  const size_t smem = sizeof(float) * static_cast<size_t>(rows) * dc * nbins;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        earl::weighted_hist_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(ranges, (R + rows - 1) / rows, (d + dc - 1) / dc);
  earl::weighted_hist_kernel<<<grid, earl::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
