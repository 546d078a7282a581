// Output-tiled histogram pass over x with implicit Poisson(1) weights: the
// sketch of a row whose bins do not fit in one SM's shared memory.
//
// Replaces the TPU kernel repro/kernels/weighted_hist/kernel.py:
// fused_poisson_hist_binblocked_kernel (_fph_binblocked_kernel), on its
// threefry path: counts (B, d, nbins), or (B, G, d, nbins) with a key
// column (GROUP BY; the reference answers that through its scan).  The
// flat bin axis of a row, (key·d + dim)·nbins + bin, is cut into windows
// of `width` bins (at most block_bins), which a CTA keeps in shared memory
// one at a time for its (at most 4) rows of W.
//
// Draw once, then walk the windows over the cache.  A thread block cluster
// of `cluster` (1 or 2) CTAs shares one block of rows and one range of
// whole RNG n-tiles.  Each CTA first draws the weights of its rows on its
// own n-tiles ONCE, with the keys of every other pass, (seed, b-tile,
// n-tile) (poisson_tile.cuh), into a shared weight cache: a weight is the
// count of Poisson(1) rungs below u, a whole number in 0..10, so one byte
// holds it, and the 4 rows of 4 columns are one 16-byte word.  Columns
// past n_valid, masked out (mask 0) or with a key outside [0, G) store 0
// without hashing.  After a cluster barrier, each CTA owns every
// cluster-th window: it zeroes the window, walks all the cluster's
// columns, reading its peer's cache through distributed shared memory (one
// 16-byte load a 4-column group), bins each value of the window's
// dimension with hist_tile.cuh's bin_index against the TRUE nbins, adds
// each nonzero weight into its bin, and flushes the window into the
// output.  A CTA leaves only after a second cluster barrier, so no peer
// reads a cache that is gone.  With one range a CTA owns its bins outright
// and flushes them with plain stores into an uninitialised output; with
// more ranges it adds its nonzero bins into the zeroed output with global
// atomics.
//
// The adds are u32 shared atomics of the whole-number weights: Hopper runs
// them about 6.6x faster than f32 shared atomics, which it emulates with a
// compare-and-swap loop.  A mask value other than 0 or 1 (NaN included)
// makes the weights fractional: a cluster that reads one adds weight × mask
// with f32 atomics instead, as the plain version multiplies.  Counts are
// sums of whole numbers, exact below 2^24 a bin under any order, so the
// result is bitwise the plain version (hist_plain, grouped_hist_plain), and
// fused_pass's histogram where that fits.
//
// Bound: operations, the hash (73 int32 operations a weight,
// poisson_tile.cuh), now paid once a weight.  Beside it, and not in the
// bound, come about 0.632·B·n·d shared atomic adds (a Poisson(1) weight is
// nonzero with probability 1 − 1/e), one bin_index a value for each block
// of rows (Bp/rows · n·d), and a flush of Bp·(G·)d·nbins bins per range.
// The shared adds set the practical floor.
//
// x arrives transposed, (d, np), so a window's dimension is read
// coalesced, 4 columns a thread as one 16-byte load when bn is a multiple
// of 4 and there is no key column.  Grid: x = range · cluster + rank,
// y = blocks of `rows` rows of W.  A CTA's rows span at most two RNG
// b-tiles (rows <= 4 <= bb).  _pass.py: binblocked_geometry mirrors the
// geometry and the shared-memory layout.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"
#include "poisson_tile.cuh"

namespace earl {

namespace cg = cooperative_groups;

constexpr int kBinThreads = 512;
constexpr int kCacheRows = 4;  // rows of a CTA at most: one 16-byte word
constexpr int kBatch = 4;      // 4-column groups a thread loads at once

struct BinBlockedParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;  // padded rows, RNG tile shape, padded columns
  int d, G;            // G = 1 without a key column
  const float* xt;     // (d, np): x transposed, 16-byte aligned
  const float* mask;   // (np), or nullptr
  const float* keys;   // (np) key of each column as f32, or nullptr
  int nbins;
  const float* lo;     // (d,)
  const float* hi;     // (d,)
  int total;           // G·d·nbins bins a row
  int width;           // bins a window
  int windows;         // windows a row
  int rows;            // rows of W per CTA (<= kCacheRows)
  int tiles_per_cta;   // n-tiles a CTA caches
  int cluster;         // CTAs a cluster
  int groups;          // 4-column groups of a CTA's cache
  int bins_bytes;      // shared bytes of the window's bins (16-aligned)
  bool vec;            // 16-byte loads of x
  float* out;          // (Bp, total); zeroed by the caller when ranges > 1
  bool store;          // one range: plain stores of every bin
};

// Adds the cached weights of column c of a 4-column group (byte c of each
// row's word) at the window-local bin `local`: whole counts into `ubins`,
// or, with a fractional mask, weight × mask into the same bins as f32.
__device__ __forceinline__ void add_column(uint32_t* ubins, int wlen,
                                           int local, const uint4& wd, int c,
                                           bool exact, float mk) {
  const uint32_t row[kCacheRows] = {wd.x, wd.y, wd.z, wd.w};
#pragma unroll
  for (int r = 0; r < kCacheRows; ++r) {
    const uint32_t wb = (row[r] >> (8 * c)) & 0xffu;
    if (wb == 0u) continue;
    if (exact) {
      atomicAdd(ubins + r * wlen + local, wb);
    } else {
      atomicAdd(reinterpret_cast<float*>(ubins) + r * wlen + local,
                __fmul_rn(static_cast<float>(wb), mk));
    }
  }
}

__global__ void __launch_bounds__(kBinThreads, 1)
binblocked_kernel(BinBlockedParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int frac_mask;  // this CTA's columns hold a mask value not 0/1
  uint32_t* ubins = reinterpret_cast<uint32_t*>(smem_raw);
  uint4* cache = reinterpret_cast<uint4*>(smem_raw + p.bins_bytes);
  TileKey* keys = reinterpret_cast<TileKey*>(cache + p.groups);
  cg::cluster_group cluster = cg::this_cluster();

  const int C = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int range = blockIdx.x / C;
  const int nt = p.np / p.bn;
  const int r0 = blockIdx.y * p.rows;
  const int nrows = min(p.rows, p.Bp - r0);

  // ---- draw: this CTA's rows on its own n-tiles, once, into the cache
  {
    const int t0 = min((range * C + rank) * p.tiles_per_cta, nt);
    const int t1 = min(t0 + p.tiles_per_cta, nt);
    const int i_first = r0 / p.bb;
    if (threadIdx.x == 0) frac_mask = 0;
    for (int q = threadIdx.x; q < 2 * (t1 - t0); q += blockDim.x) {
      keys[q] = tile_key(p.seed, static_cast<uint32_t>(i_first + (q & 1)),
                         static_cast<uint32_t>(t0 + (q >> 1)));
    }
    __syncthreads();
    // kBinThreads is a multiple of 4, so a thread keeps one row
    const int r = threadIdx.x & 3;
    const int b = r0 + r;
    const int tsel = b / p.bb - i_first;
    const int trow = b - (b / p.bb) * p.bb;
    const int ncols = (t1 - t0) * p.bn;
    const int64_t c0 = static_cast<int64_t>(t0) * p.bn;
    uint32_t* words = reinterpret_cast<uint32_t*>(cache);
    bool frac = false;
    for (int q = threadIdx.x >> 2; q < p.groups; q += kBinThreads / 4) {
      uint32_t word = 0u;
      if (r < nrows) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * q + c;
          if (k >= ncols) break;
          const int64_t j = c0 + k;
          // weights that are zero by n_valid, the mask or the key: no hash
          if (j >= p.n_valid) break;
          if (p.mask != nullptr) {
            const float m = p.mask[j];
            if (m == 0.f) continue;
            frac |= m != 1.f;
          }
          if (p.keys != nullptr && column_key(p.keys[j], p.G) < 0) continue;
          const int tl = k / p.bn;
          uint32_t x0 = 0u;
          uint32_t x1 = static_cast<uint32_t>(trow * p.bn + (k - tl * p.bn));
          const TileKey tk = keys[2 * tl + tsel];
          threefry2x32(tk.k0, tk.k1, x0, x1);
          word |= static_cast<uint32_t>(poisson_from_bits(x0 ^ x1))
                  << (8 * c);
        }
      }
      words[q * kCacheRows + r] = word;
    }
    if (frac) frac_mask = 1;
  }
  cluster.sync();
  bool exact = true;
  for (int peer = 0; peer < C; ++peer) {
    exact = exact && *cluster.map_shared_rank(&frac_mask, peer) == 0;
  }

  // ---- walk: every cluster-th window over all the cluster's columns
  for (int win = rank; win < p.windows; win += C) {
    const int w0 = win * p.width;
    const int wlen = min(p.width, p.total - w0);
    // the slots (key·d + dim) whose bins the window holds
    const int s_lo = w0 / p.nbins;
    const int s_hi = (w0 + wlen - 1) / p.nbins;
    for (int e = threadIdx.x; e < nrows * wlen; e += blockDim.x) ubins[e] = 0u;
    __syncthreads();

    if (p.keys == nullptr && p.vec && exact && s_lo == s_hi) {
      // one dimension's bins, whole counts: kBatch groups' cache words and
      // x values are loaded before any is used, so their latencies overlap
      const float lo = p.lo[s_lo], hi = p.hi[s_lo];
      const float* xrow = p.xt + static_cast<int64_t>(s_lo) * p.np;
      for (int peer = 0; peer < C; ++peer) {
        const int tp0 = min((range * C + peer) * p.tiles_per_cta, nt);
        const int tp1 = min(tp0 + p.tiles_per_cta, nt);
        const int nq = (tp1 - tp0) * p.bn / 4;  // whole groups: bn % 4 == 0
        const uint4* src =
            peer == rank ? cache : cluster.map_shared_rank(cache, peer);
        const float* xs = xrow + static_cast<int64_t>(tp0) * p.bn;
        for (int q0 = threadIdx.x; q0 < nq; q0 += kBatch * kBinThreads) {
          uint4 wd[kBatch];
          float4 x4[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int q = q0 + k * kBinThreads;
            wd[k] = make_uint4(0u, 0u, 0u, 0u);
            if (q < nq) {
              wd[k] = src[q];
              x4[k] = *reinterpret_cast<const float4*>(xs + 4 * q);
            }
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const uint32_t any = wd[k].x | wd[k].y | wd[k].z | wd[k].w;
            if (any == 0u) continue;
            const float xv[4] = {x4[k].x, x4[k].y, x4[k].z, x4[k].w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (((any >> (8 * c)) & 0xffu) == 0u) continue;
              if (isnan(xv[c])) continue;  // NaN carries no mass
              const int local =
                  s_lo * p.nbins + bin_index(xv[c], lo, hi, p.nbins) - w0;
              if (local < 0 || local >= wlen) continue;
              add_column(ubins, wlen, local, wd[k], c, true, 1.f);
            }
          }
        }
      }
    } else {
      for (int u = threadIdx.x; u < C * p.groups; u += blockDim.x) {
        const int peer = u / p.groups;
        const int q = u - peer * p.groups;
        const int tp0 = min((range * C + peer) * p.tiles_per_cta, nt);
        const int tp1 = min(tp0 + p.tiles_per_cta, nt);
        if (4 * q >= (tp1 - tp0) * p.bn) continue;
        const uint4 wd =
            (peer == rank ? cache : cluster.map_shared_rank(cache, peer))[q];
        const uint32_t any = wd.x | wd.y | wd.z | wd.w;
        if (any == 0u) continue;  // every weight of the 4 columns is zero
        const int64_t j0 = static_cast<int64_t>(tp0) * p.bn + 4 * q;
        float mk[4] = {1.f, 1.f, 1.f, 1.f};
        if (!exact) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if ((any >> (8 * c)) & 0xffu) mk[c] = p.mask[j0 + c];
          }
        }
        if (p.keys == nullptr) {
          for (int s = s_lo; s <= s_hi; ++s) {
            const float lo = p.lo[s], hi = p.hi[s];
            const float* xs = p.xt + static_cast<int64_t>(s) * p.np + j0;
            float xv[4];
            if (p.vec) {
              const float4 x4 = *reinterpret_cast<const float4*>(xs);
              xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                xv[c] = ((any >> (8 * c)) & 0xffu) ? xs[c] : 0.f;
              }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (((any >> (8 * c)) & 0xffu) == 0u) continue;
              if (isnan(xv[c])) continue;  // NaN carries no mass
              const int local =
                  s * p.nbins + bin_index(xv[c], lo, hi, p.nbins) - w0;
              if (local < 0 || local >= wlen) continue;
              add_column(ubins, wlen, local, wd, c, exact, mk[c]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (((any >> (8 * c)) & 0xffu) == 0u) continue;
            // a nonzero weight was drawn, so the key is valid
            const int g = column_key(p.keys[j0 + c], p.G);
            const int s_a = max(s_lo, g * p.d);
            const int s_b = min(s_hi, g * p.d + p.d - 1);
            for (int s = s_a; s <= s_b; ++s) {
              const int dd = s - g * p.d;
              const float xv = p.xt[static_cast<int64_t>(dd) * p.np + j0 + c];
              if (isnan(xv)) continue;  // NaN carries no mass
              const int local =
                  s * p.nbins + bin_index(xv, p.lo[dd], p.hi[dd], p.nbins) - w0;
              if (local < 0 || local >= wlen) continue;
              add_column(ubins, wlen, local, wd, c, exact, mk[c]);
            }
          }
        }
      }
    }
    __syncthreads();
    // whole counts below 2^24 convert to f32 exactly
    for (int e = threadIdx.x; e < nrows * wlen; e += blockDim.x) {
      const float v = exact ? static_cast<float>(ubins[e])
                            : reinterpret_cast<const float*>(ubins)[e];
      const int r = e / wlen;
      float* dst =
          p.out + static_cast<int64_t>(r0 + r) * p.total + w0 + (e - r * wlen);
      if (p.store) {
        *dst = v;
      } else if (v != 0.f) {
        atomicAdd(dst, v);
      }
    }
    __syncthreads();
  }
  // the peer may still read this CTA's cache
  cluster.sync();
}

}  // namespace earl

// Returns cudaGetLastError() after the launch (or the launch's own error).
extern "C" int earl_fused_binblocked(
    int32_t seed, int32_t n_valid, int Bp, int np, int bb, int bn, int d,
    int G, const void* xt, const void* mask, const void* keys, int nbins,
    const void* lo, const void* hi, int width, int rows, int tiles_per_cta,
    int cluster, int ranges, void* out, void* stream) {
  // A CTA's rows must span at most two RNG b-tiles (fused_pass.cu).
  if (bb < earl::kCacheRows || rows < 1 || rows > earl::kCacheRows ||
      d < 1 || G < 1 || nbins < 1 || width < 1 || ranges < 1 ||
      cluster < 1 || cluster > 8 || tiles_per_cta < 1 || bn < 1 ||
      np % bn != 0 || (reinterpret_cast<uintptr_t>(xt) & 15u) != 0) {
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
  p.windows = (p.total + width - 1) / width;
  p.rows = rows; p.tiles_per_cta = tiles_per_cta; p.cluster = cluster;
  p.groups = (tiles_per_cta * bn + 3) / 4;
  p.bins_bytes = (4 * rows * width + 15) / 16 * 16;
  p.vec = bn % 4 == 0;
  p.out = static_cast<float*>(out);
  p.store = ranges == 1;
  const size_t smem = static_cast<size_t>(p.bins_bytes) +
                      16 * static_cast<size_t>(p.groups) +
                      sizeof(earl::TileKey) * 2 * tiles_per_cta;
  cudaError_t e = cudaFuncSetAttribute(
      earl::binblocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranges * cluster, (Bp + rows - 1) / rows, 1);
  cfg.blockDim = dim3(earl::kBinThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, earl::binblocked_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
