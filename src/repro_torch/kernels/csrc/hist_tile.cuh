// Histogram-sketch tile math: the binning rule and the shared-memory bins.
//
// Replaces the one-hot MXU contraction of the TPU kernels
// (repro/kernels/weighted_hist/kernel.py: _fph_kernel;
// repro/kernels/fused_multi/kernel.py: _fm_kernel hist slots).  That
// formulation costs B·bn·d·nbins multiply-adds per tile; here each weight
// lands in its bin with one shared-memory atomic add.  Counts are sums of
// small integer weights, exact in f32 below 2^24 under any order, so the
// atomics keep the result bitwise deterministic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace earl {

// Bin of x, bit for bit the rule of repro/kernels/weighted_hist/ref.py:
// span = hi - lo + 1e-12 in f32, (x - lo) / span * nbins with IEEE
// division, clipped in f32, truncated, clipped again.  Out-of-range
// values and +-inf land in the edge bins; the caller drops NaN mass.
__device__ __forceinline__ int bin_index(float x, float lo, float hi,
                                         int nbins) {
  const float span = __fadd_rn(__fsub_rn(hi, lo), 1e-12f);
  float f = __fmul_rn(__fdiv_rn(__fsub_rn(x, lo), span),
                      static_cast<float>(nbins));
  f = fminf(fmaxf(f, 0.f), static_cast<float>(nbins - 1));
  const int i = static_cast<int>(f);
  return min(max(i, 0), nbins - 1);
}

// Adds a CTA's bins (rows x total floats in shared memory) into the
// output rows starting at row r0; empty bins are skipped.
__device__ __forceinline__ void flush_bins(const float* bins, int rows,
                                           int total, float* out, int r0) {
  for (int e = threadIdx.x; e < rows * total; e += blockDim.x) {
    const float v = bins[e];
    if (v != 0.f) {
      atomicAdd(out + static_cast<int64_t>(r0) * total + e, v);
    }
  }
}

}  // namespace earl
