// Histogram-sketch tile math: the binning rule and the shared-memory bins.
//
// Replaces the one-hot MXU contraction of the TPU kernels
// (repro/kernels/weighted_hist/kernel.py: _fph_kernel;
// repro/kernels/fused_multi/kernel.py: _fm_kernel hist slots).  That
// formulation costs B·bn·d·nbins multiply-adds per tile; here each weight
// lands in its bin with one shared-memory atomic add.
//
// Whole-number weights (a Poisson count times an exact 0/1 mask) add into
// u32 bins: Hopper runs u32 shared atomics about 6.6x faster than f32
// ones, which it emulates with a compare-and-swap loop.  A CTA whose mask
// columns hold another value adds weight × mask into the same bins as
// f32.  A u32 bin cannot overflow, and converts to f32 exactly: a CTA
// covers at most 1024 RNG tiles of 512 columns (_pass.MAX_TILES_PER_CTA,
// BLOCK_N) and a weight is at most 10 (the rungs of poisson_from_bits), so
// a bin holds at most 5,242,880 < 2^24.  Counts are sums of whole
// numbers, exact in f32 below 2^24 under any order, so the atomics keep
// the result bitwise deterministic.
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

// The key of a column, kf, when it is a whole number in [0, G), else -1
// (NaN included: (key == g) holds for no g).
__device__ __forceinline__ int column_key(float kf, int G) {
  if (!(kf >= 0.f && kf < static_cast<float>(G))) return -1;
  const int g = static_cast<int>(kf);
  return static_cast<float>(g) == kf ? g : -1;
}

// Adds one weight a row at bin `idx` of each of a CTA's R rows (row r at
// bins + r * stride): the whole count into the u32 bins, or, when not
// `exact`, the f32 weight into the same bins read as f32.  Zero weights
// are skipped.
template <int R>
__device__ __forceinline__ void add_weights(uint32_t* bins, int stride,
                                            int idx, const float (&w)[R],
                                            bool exact) {
  if (exact) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (w[r] != 0.f) {
        atomicAdd(bins + r * stride + idx, __float2uint_rz(w[r]));
      }
    }
  } else {
    float* fbins = reinterpret_cast<float*>(bins);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (w[r] != 0.f) atomicAdd(fbins + r * stride + idx, w[r]);
    }
  }
}

// Adds `width` bins of each of a CTA's `rows` rows (row r at
// bins + r * stride: u32 counts when `exact`, else f32) into the output
// rows out + r * out_stride with global atomics; empty bins are skipped.
__device__ __forceinline__ void flush_bins(const uint32_t* bins, bool exact,
                                           int rows, int width, int stride,
                                           float* out, int64_t out_stride) {
  for (int r = 0; r < rows; ++r) {
    for (int b = threadIdx.x; b < width; b += blockDim.x) {
      const uint32_t v = bins[r * stride + b];
      if (v == 0u) continue;
      const float f = exact ? __uint2float_rn(v) : __uint_as_float(v);
      atomicAdd(out + r * out_stride + b, f);
    }
  }
}

// Zeroes `count` u32 bins at a 16-byte aligned `bins`.
__device__ __forceinline__ void zero_bins(uint32_t* bins, int count) {
  uint4* v = reinterpret_cast<uint4*>(bins);
  for (int e = threadIdx.x; e < count / 4; e += blockDim.x) {
    v[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = count / 4 * 4 + threadIdx.x; e < count; e += blockDim.x) {
    bins[e] = 0u;
  }
}

}  // namespace earl
