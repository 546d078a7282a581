// One pass over x with implicit Poisson(1) weights, feeding a moments
// accumulator, histogram sketches, or both from the SAME weights.
//
// Replaces three TPU kernels, each an instance of the template below,
// picked in earl_fused_pass by which outputs the caller passes:
//   fused_pass_kernel<true, false, DC>  moments only (kernel 2):
//       fused_poisson_moments_kernel (repro/kernels/weighted_stats/
//       kernel.py, _fpm_kernel), ungrouped, f32, with n_valid and the
//       validity mask;
//   fused_pass_kernel<false, true, 1>   histograms only (kernel 3):
//       fused_poisson_hist_kernel (repro/kernels/weighted_hist/kernel.py,
//       _fph_kernel), without its one-hot contraction (see hist_tile.cuh);
//   fused_pass_kernel<true, true, DC>   a StatisticGroup (kernel 4):
//       fused_poisson_multi_kernel (repro/kernels/fused_multi/kernel.py,
//       _fm_kernel), one weight for at most one moments slot and any
//       number of histogram slots.
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
// y = blocks of `rows` rows of W, z = chunks of DC moment columns (DC =
// dim_chunk(d): a thread keeps 8 rows x (1 + 2·DC) accumulators, so d = 1
// carries no dead ones).  A CTA derives the keys of every RNG tile it
// touches into shared memory once; its rows span at most two RNG b-tiles
// because rows <= 8 <= bb (the wrappers' tile clamp gives bb >= 8).
// Only z == 0 does w_tot and the histograms.  Its shared memory, in this
// order (_pass.pass_smem_bytes mirrors it): the tile keys; the histogram
// slots' (nbins, offset) pairs and their lo and hi, read once a CTA; the
// bins of its rows, added to the output once at the end.  The bins hold
// whole counts as u32, or, for a CTA whose mask columns hold a value other
// than 0/1, f32 (hist_tile.cuh).
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
  const float* mask;   // (np), or nullptr
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

// Bytes before the bins: the tile keys, the slots' meta, lo and hi.
__host__ __device__ inline size_t pass_meta_end(const PassParams& p) {
  const size_t end = sizeof(TileKey) * 2 * p.tiles_per_cta +
                     sizeof(int) * 2 * p.n_hist +
                     sizeof(float) * 2 * p.n_hist * p.d;
  return (end + 15) / 16 * 16;
}

inline size_t pass_smem_bytes(const PassParams& p, bool hist) {
  if (!hist) return sizeof(TileKey) * 2 * p.tiles_per_cta;
  return pass_meta_end(p) + sizeof(uint32_t) * p.rows * p.hist_total;
}

// True, in every thread of the CTA, when mask columns [c0, c1) hold a
// value other than 0 or 1 (NaN included): the CTA's weights are then not
// whole numbers and it adds them as f32 (hist_tile.cuh).  No mask: false.
// Every thread of the CTA must call it (it ends in __syncthreads_or).
__device__ __forceinline__ bool cta_fractional_mask(const float* mask,
                                                    int64_t c0, int64_t c1) {
  bool frac = false;
  if (mask != nullptr) {
    for (int64_t j = c0 + threadIdx.x; j < c1; j += blockDim.x) {
      const float m = __ldg(mask + j);
      frac |= m != 0.f && m != 1.f;
    }
  }
  return __syncthreads_or(frac) != 0;
}

template <bool MOM, bool HIST, int DC>
__global__ void __launch_bounds__(kThreads)
fused_pass_kernel(PassParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kWarps];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  int* meta = reinterpret_cast<int*>(keys + 2 * p.tiles_per_cta);
  float* slot_lo = reinterpret_cast<float*>(meta + 2 * p.n_hist);
  float* slot_hi = slot_lo + p.n_hist * p.d;
  uint32_t* bins = nullptr;
  if (HIST) bins = reinterpret_cast<uint32_t*>(smem_raw + pass_meta_end(p));

  const int range = blockIdx.x;
  const int r0 = blockIdx.y * p.rows;
  const int dz = blockIdx.z * DC;
  const bool lead = blockIdx.z == 0;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(p.rows, p.Bp - r0);

  int tsel[kMaxRows], trow[kMaxRows];
  cta_tile_keys<kMaxRows>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);
  bool exact = true;
  if (HIST && lead) {
    zero_bins(bins, nrows * p.hist_total);
    for (int e = threadIdx.x; e < 2 * p.n_hist; e += blockDim.x) {
      meta[e] = p.hist_meta[e];
    }
    for (int e = threadIdx.x; e < p.n_hist * p.d; e += blockDim.x) {
      slot_lo[e] = p.hist_lo[e];
      slot_hi[e] = p.hist_hi[e];
    }
    const int64_t c0 = static_cast<int64_t>(t0) * p.bn;
    const int64_t c1 = min(static_cast<int64_t>(t1) * p.bn,
                           static_cast<int64_t>(p.n_valid));
    exact = !cta_fractional_mask(p.mask, c0, c1);
  }
  __syncthreads();

  float acc_w[kMaxRows];
  float acc_s1[kMaxRows][DC];
  float acc_s2[kMaxRows][DC];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    acc_w[r] = 0.f;
#pragma unroll
    for (int q = 0; q < DC; ++q) acc_s1[r][q] = acc_s2[r][q] = 0.f;
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
        float xv[DC], x2[DC];
#pragma unroll
        for (int q = 0; q < DC; ++q) {
          xv[q] = dz + q < p.d ? p.x[j * p.d + dz + q] : 0.f;
          x2[q] = __fmul_rn(xv[q], xv[q]);
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          acc_w[r] = __fadd_rn(acc_w[r], w[r]);
#pragma unroll
          for (int q = 0; q < DC; ++q) {
            acc_s1[r][q] = __fmaf_rn(w[r], xv[q], acc_s1[r][q]);
            acc_s2[r][q] = __fmaf_rn(w[r], x2[q], acc_s2[r][q]);
          }
        }
      }
      if (HIST && lead) {
        for (int h = 0; h < p.n_hist; ++h) {
          const int nb = meta[2 * h];
          const int off = meta[2 * h + 1];
          for (int dd = 0; dd < p.d; ++dd) {
            const float xv = __ldg(p.x + j * p.d + dd);
            if (isnan(xv)) continue;  // NaN carries no mass
            const int bin = bin_index(xv, slot_lo[h * p.d + dd],
                                      slot_hi[h * p.d + dd], nb);
            add_weights(bins, p.hist_total, off + dd * nb + bin, w, exact);
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
    flush_bins(bins, exact, nrows, p.hist_total, p.hist_total,
               p.hist_out + static_cast<int64_t>(r0) * p.hist_total,
               p.hist_total);
  }
}

// Launches the pass and, for moments, the in-order sum of the partials.
// Returns cudaGetLastError() after the launches.
template <bool MOM, bool HIST, int DC>
int launch_pass(const PassParams& p, float* w_tot, float* s1, float* s2,
                cudaStream_t stream) {
  // A CTA's rows must span at most two RNG b-tiles (see the top).
  if (p.rows < 1 || p.rows > kMaxRows || p.bb < kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = pass_smem_bytes(p, HIST);
  auto kernel = fused_pass_kernel<MOM, HIST, DC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int zdim = MOM ? (p.d + DC - 1) / DC : 1;
  dim3 grid(p.ranges, (p.Bp + p.rows - 1) / p.rows, zdim);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  if (MOM) {
    sum_fused_partials(p.part_w, p.part_s1, p.part_s2, w_tot, s1, s2, p.Bp,
                       p.ranges, 1, p.d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// The moments instance of dim_chunk(d).
template <bool HIST>
int launch_moments_pass(const PassParams& p, float* w_tot, float* s1,
                        float* s2, cudaStream_t stream) {
  switch (dim_chunk(p.d)) {
    case 1: return launch_pass<true, HIST, 1>(p, w_tot, s1, s2, stream);
    case 2: return launch_pass<true, HIST, 2>(p, w_tot, s1, s2, stream);
    default: return launch_pass<true, HIST, kDimChunk>(p, w_tot, s1, s2,
                                                       stream);
  }
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
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool mom = part_w != nullptr;
  if (mom && n_hist > 0) {
    return earl::launch_moments_pass<true>(p, wt, a1, a2, s);
  }
  if (mom) return earl::launch_moments_pass<false>(p, wt, a1, a2, s);
  return earl::launch_pass<false, true, 1>(p, nullptr, nullptr, nullptr, s);
}
