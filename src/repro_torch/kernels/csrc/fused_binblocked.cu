// Output-tiled histogram pass over x with implicit Poisson(1) weights: the
// sketch of a row whose bins do not fit in one SM's shared memory.
//
// Replaces the TPU kernel repro/kernels/weighted_hist/kernel.py:
// fused_poisson_hist_binblocked_kernel (_fph_binblocked_kernel), on its
// threefry path: counts (B, d, nbins), or (B, G, d, nbins) with a key
// column (GROUP BY; the reference answers that through its scan).  The
// flat bin axis of a row, (key·d + dim)·nbins + bin, is cut into windows
// of `width` bins (at most block_bins); a CTA owns one window of at most 8
// rows of W over a range of whole RNG n-tiles, keeps that window in shared
// memory and adds it into the output once, with global atomics, at the end.
//
// Each CTA regenerates its weights from poisson_tile.cuh with the keys of
// every other pass, (seed, b-tile, n-tile), and bins each value against the
// TRUE nbins with hist_tile.cuh's bin_index; a weight is added (shared
// atomic) only when the value's flat bin falls inside the window.  Counts
// are sums of whole numbers, exact in f32 below 2^24 a bin under any order
// of the shared and global atomics, so the result is bitwise the plain
// version (hist_plain), and fused_pass's histogram where that fits.
//
// Bound: operations, the hash (73 int32 operations a weight,
// poisson_tile.cuh).  The design hashes a weight once per window its
// column has a value in: a column with no value in the window (another
// dimension's or key's bins, a bin outside a narrow window, a masked or
// padded column) is skipped before its weights are drawn, so the recompute
// factor is the number of windows a column's values land in, at most the
// window count; with one dimension per window (block_bins = nbins) it is
// d, the price of keeping the output out of registers and shared memory.
// Cross-range partials are never materialized: ranges add their windows
// into the zeroed output with global atomics of whole counts.
//
// x arrives transposed, (d, np), so a window's dimension is read
// coalesced.  Grid: x = window · ranges + range, y = blocks of `rows`
// rows of W.  A CTA's rows span at most two RNG b-tiles (rows <= 8 <= bb).
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"
#include "moments_tile.cuh"
#include "poisson_tile.cuh"

namespace earl {

struct BinBlockedParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;  // padded rows, RNG tile shape, padded columns
  int d, G;            // G = 1 without a key column
  const float* xt;     // (d, np): x transposed
  const float* mask;   // (np) exact 0/1, or nullptr
  const float* keys;   // (np) key of each column as f32, or nullptr
  int nbins;
  const float* lo;     // (d,)
  const float* hi;     // (d,)
  int total;           // G·d·nbins bins a row
  int width;           // bins a window
  int rows;            // rows of W per CTA (<= kMaxRows)
  int tiles_per_cta;
  int ranges;
  float* out;          // (Bp, total), zeroed by the caller
};

__global__ void __launch_bounds__(kThreads)
binblocked_kernel(BinBlockedParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  float* bins = reinterpret_cast<float*>(keys + 2 * p.tiles_per_cta);

  const int win = blockIdx.x / p.ranges;
  const int range = blockIdx.x - win * p.ranges;
  const int r0 = blockIdx.y * p.rows;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(p.rows, p.Bp - r0);
  const int w0 = win * p.width;
  const int wlen = min(p.width, p.total - w0);
  // the slots (key·d + dim) whose bins the window holds
  const int s_lo = w0 / p.nbins;
  const int s_hi = (w0 + wlen - 1) / p.nbins;

  int tsel[kMaxRows], trow[kMaxRows];
  cta_tile_keys<kMaxRows>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);
  for (int e = threadIdx.x; e < nrows * wlen; e += blockDim.x) bins[e] = 0.f;
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const TileKey* tk = keys + 2 * (t - t0);
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      const int64_t j = static_cast<int64_t>(t) * p.bn + c;
      // Columns whose weights are all zero add nothing: skip the hash.
      if (j >= p.n_valid) continue;
      if (p.mask != nullptr && p.mask[j] == 0.f) continue;
      int g = 0;
      if (p.keys != nullptr) {
        // A key that is not a whole number in [0, G) (NaN included) is in
        // no slot, as (key == g) holds for no g.
        const float kf = p.keys[j];
        if (!(kf >= 0.f && kf < static_cast<float>(p.G))) continue;
        g = static_cast<int>(kf);
        if (static_cast<float>(g) != kf) continue;
      }
      const int s_a = max(s_lo, g * p.d);
      const int s_b = min(s_hi, g * p.d + p.d - 1);
      bool drawn = false;
      float w[kMaxRows];
      for (int s = s_a; s <= s_b; ++s) {
        const int dd = s - g * p.d;
        const float xv = p.xt[static_cast<int64_t>(dd) * p.np + j];
        if (isnan(xv)) continue;  // NaN carries no mass
        const int local =
            s * p.nbins + bin_index(xv, p.lo[dd], p.hi[dd], p.nbins) - w0;
        if (local < 0 || local >= wlen) continue;
        if (!drawn) {
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            w[r] = r < nrows ? implicit_weight(
                                   tk[tsel[r]],
                                   static_cast<uint32_t>(trow[r] * p.bn + c),
                                   j, p.n_valid, p.mask)
                             : 0.f;
          }
          drawn = true;
        }
        float* dst = bins + local;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (w[r] != 0.f) atomicAdd(dst + r * wlen, w[r]);
        }
      }
    }
  }
  __syncthreads();
  flush_window(bins, nrows, wlen, p.out, p.total, r0, w0);
}

}  // namespace earl

// Returns cudaGetLastError() after the launch.
extern "C" int earl_fused_binblocked(
    int32_t seed, int32_t n_valid, int Bp, int np, int bb, int bn, int d,
    int G, const void* xt, const void* mask, const void* keys, int nbins,
    const void* lo, const void* hi, int width, int rows, int tiles_per_cta,
    int ranges, void* out, void* stream) {
  // A CTA's rows must span at most two RNG b-tiles (fused_pass.cu).
  if (bb < earl::kMaxRows || rows < 1 || rows > earl::kMaxRows || d < 1 ||
      G < 1 || nbins < 1 || width < 1 || ranges < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::BinBlockedParams p{};
  p.seed = seed;
  p.n_valid = n_valid;
  p.Bp = Bp; p.bb = bb; p.bn = bn; p.np = np; p.d = d; p.G = G;
  p.xt = static_cast<const float*>(xt);
  p.mask = static_cast<const float*>(mask);
  p.keys = static_cast<const float*>(keys);
  p.nbins = nbins;
  p.lo = static_cast<const float*>(lo);
  p.hi = static_cast<const float*>(hi);
  p.total = G * d * nbins;
  p.width = width;
  p.rows = rows; p.tiles_per_cta = tiles_per_cta; p.ranges = ranges;
  p.out = static_cast<float*>(out);
  const size_t smem = sizeof(earl::TileKey) * 2 * tiles_per_cta +
                      sizeof(float) * static_cast<size_t>(rows) * width;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        earl::binblocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int windows = (p.total + width - 1) / width;
  dim3 grid(windows * ranges, (Bp + rows - 1) / rows, 1);
  earl::binblocked_kernel<<<grid, earl::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
