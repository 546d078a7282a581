// One pass over x with implicit Poisson(1) weights, feeding a moments
// accumulator, histogram sketches, or both from the SAME weights.
//
// Replaces three TPU kernels, each an instance of the template below,
// picked in earl_fused_pass by which outputs the caller passes:
//   fused_pass_kernel<true, false>  moments only: fused_poisson_moments_kernel
//       (repro/kernels/weighted_stats/kernel.py, _fpm_kernel), ungrouped,
//       f32, with n_valid and the validity mask;
//   fused_pass_kernel<false, true>  histograms only: fused_poisson_hist_kernel
//       (repro/kernels/weighted_hist/kernel.py, _fph_kernel), without its
//       one-hot contraction (see hist_tile.cuh);
//   fused_pass_kernel<true, true>   a StatisticGroup: fused_poisson_multi_kernel
//       (repro/kernels/fused_multi/kernel.py, _fm_kernel), one weight for at
//       most one moments slot and any number of histogram slots.
// A group member is bitwise equal to its dedicated kernel by construction:
// the weights, the column order of every thread, the block reduction and
// the column ranges are the same code and the same shapes.
//
// Bound: the integer work of one threefry2x32 per weight (the count is in
// poisson_tile.cuh), paid once for every slot; x is read once per block of
// rows of W, the binning is one IEEE division per value and block of rows,
// and the shared-memory atomics one per nonzero weight.
//
// Grid: x = column ranges (whole RNG n-tiles, `tiles_per_cta` each),
// y = blocks of `rows` rows of W, z = chunks of kDimChunk moment columns.
// A CTA derives the keys of every RNG tile it touches into shared memory
// once; its rows span at most two RNG b-tiles because rows <= 8 <= bb
// (the wrappers' tile clamp gives bb >= 8).  Histogram bins of the CTA's
// rows live in shared memory and are added to the output once at the end.
// Only z == 0 does w_tot and the histograms.
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"
#include "moments_tile.cuh"
#include "poisson_tile.cuh"

namespace earl {

struct PassParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;  // padded rows, RNG tile shape, padded columns
  int d;
  const float* x;      // (np, d)
  const float* mask;   // (np) exact 0/1, or nullptr
  int rows;            // rows of W per CTA (<= kMaxRows)
  int tiles_per_cta;
  int ranges;
  // moments: partials (Bp, ranges) and (Bp, ranges, d)
  float* part_w;
  float* part_s1;
  float* part_s2;
  // histograms: slot h has nbins = meta[2h] and column offset meta[2h+1]
  // in the (Bp, hist_total) output; lo/hi are (n_hist, d).
  int n_hist;
  const int* hist_meta;
  const float* hist_lo;
  const float* hist_hi;
  int hist_total;
  float* hist_out;
};

inline size_t pass_smem_bytes(const PassParams& p, bool hist) {
  size_t keys = sizeof(TileKey) * 2 * p.tiles_per_cta;
  size_t bins = hist ? sizeof(float) * p.rows * p.hist_total : 0;
  return keys + bins;
}

template <bool MOM, bool HIST>
__global__ void __launch_bounds__(kThreads)
fused_pass_kernel(PassParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kWarps];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  float* bins = reinterpret_cast<float*>(keys + 2 * p.tiles_per_cta);

  const int range = blockIdx.x;
  const int r0 = blockIdx.y * p.rows;
  const int dz = blockIdx.z * kDimChunk;
  const bool lead = blockIdx.z == 0;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(p.rows, p.Bp - r0);

  int tsel[kMaxRows], trow[kMaxRows];
  cta_tile_keys<kMaxRows>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);
  if (HIST && lead) {
    for (int e = threadIdx.x; e < nrows * p.hist_total; e += blockDim.x) {
      bins[e] = 0.f;
    }
  }
  __syncthreads();

  float acc_w[kMaxRows];
  float acc_s1[kMaxRows][kDimChunk];
  float acc_s2[kMaxRows][kDimChunk];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    acc_w[r] = 0.f;
#pragma unroll
    for (int q = 0; q < kDimChunk; ++q) acc_s1[r][q] = acc_s2[r][q] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const TileKey* tk = keys + 2 * (t - t0);
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      const int64_t j = static_cast<int64_t>(t) * p.bn + c;
      float w[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        w[r] = r < nrows
                   ? implicit_weight(tk[tsel[r]],
                                     static_cast<uint32_t>(trow[r] * p.bn + c),
                                     j, p.n_valid, p.mask)
                   : 0.f;
      }
      if (MOM) {
        float xv[kDimChunk], x2[kDimChunk];
#pragma unroll
        for (int q = 0; q < kDimChunk; ++q) {
          xv[q] = dz + q < p.d ? p.x[j * p.d + dz + q] : 0.f;
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
      if (HIST && lead) {
        for (int h = 0; h < p.n_hist; ++h) {
          const int nb = p.hist_meta[2 * h];
          const int off = p.hist_meta[2 * h + 1];
          for (int dd = 0; dd < p.d; ++dd) {
            const float xv = p.x[j * p.d + dd];
            if (isnan(xv)) continue;  // NaN carries no mass
            const int bin = bin_index(xv, p.hist_lo[h * p.d + dd],
                                      p.hist_hi[h * p.d + dd], nb);
            float* dst = bins + off + dd * nb + bin;
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r) {
              if (w[r] != 0.f) atomicAdd(dst + r * p.hist_total, w[r]);
            }
          }
        }
      }
    }
  }

  if (MOM) {
    write_moment_partials(acc_w, acc_s1, acc_s2, nrows, r0, range, p.ranges,
                          dz, p.d, lead, red, p.part_w, p.part_s1,
                          p.part_s2);
  }
  if (HIST && lead) {
    __syncthreads();
    flush_bins(bins, nrows, p.hist_total, p.hist_out, r0);
  }
}

// Launches the pass and, for moments, the in-order sum of the partials.
// Returns cudaGetLastError() after the launches.
template <bool MOM, bool HIST>
int launch_pass(const PassParams& p, float* w_tot, float* s1, float* s2,
                cudaStream_t stream) {
  // A CTA's rows must span at most two RNG b-tiles (see the top).
  if (p.rows < 1 || p.rows > kMaxRows || p.bb < kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = pass_smem_bytes(p, HIST);
  auto kernel = fused_pass_kernel<MOM, HIST>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int zdim = MOM ? (p.d + kDimChunk - 1) / kDimChunk : 1;
  dim3 grid(p.ranges, (p.Bp + p.rows - 1) / p.rows, zdim);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  if (MOM) {
    sum_fused_partials(p.part_w, p.part_s1, p.part_s2, w_tot, s1, s2, p.Bp,
                       p.ranges, 1, p.d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace earl

// Moments when part_w is not null, histograms when n_hist > 0.
extern "C" int earl_fused_pass(int32_t seed, int32_t n_valid, int Bp, int np,
                               int bb, int bn, int d, const void* x,
                               const void* mask, int rows, int tiles_per_cta,
                               int ranges, void* part_w, void* part_s1,
                               void* part_s2, void* w_tot, void* s1, void* s2,
                               int n_hist, const void* hist_meta,
                               const void* hist_lo, const void* hist_hi,
                               int hist_total, void* hist_out, void* stream) {
  earl::PassParams p{};
  p.seed = seed;
  p.n_valid = n_valid;
  p.Bp = Bp; p.bb = bb; p.bn = bn; p.np = np; p.d = d;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.rows = rows; p.tiles_per_cta = tiles_per_cta; p.ranges = ranges;
  p.part_w = static_cast<float*>(part_w);
  p.part_s1 = static_cast<float*>(part_s1);
  p.part_s2 = static_cast<float*>(part_s2);
  p.n_hist = n_hist;
  p.hist_meta = static_cast<const int*>(hist_meta);
  p.hist_lo = static_cast<const float*>(hist_lo);
  p.hist_hi = static_cast<const float*>(hist_hi);
  p.hist_total = hist_total;
  p.hist_out = static_cast<float*>(hist_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wt = static_cast<float*>(w_tot);
  float* a1 = static_cast<float*>(s1);
  float* a2 = static_cast<float*>(s2);
  const bool mom = part_w != nullptr;
  if (mom && n_hist > 0) return earl::launch_pass<true, true>(p, wt, a1, a2, s);
  if (mom) return earl::launch_pass<true, false>(p, wt, a1, a2, s);
  return earl::launch_pass<false, true>(p, nullptr, nullptr, nullptr, s);
}
