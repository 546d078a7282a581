// GROUP BY passes over x with implicit Poisson(1) weights: one weight per
// (row of W, column), drawn once, routed to the slot of the column's key.
//
// grouped_moments_kernel<DC, KG> replaces the TPU kernel
// repro/kernels/weighted_stats/kernel.py: fused_poisson_moments_grouped_kernel
// (_fpm_grouped_kernel) on its threefry path: w_tot (B, G) and s1, s2
// (B, G, d).  For key g it forms w_g = w · (key == g) and folds w_g, w_g·x
// and w_g·x² exactly as fused_pass.cu folds a weight, so NaN or inf in
// another key's row poisons slot g as it poisons the masked run.
//
// grouped_hist_kernel is the keyed histogram sketch: counts (B, G, d, nbins).
// The reference has no TPU kernel for it (its grouped sketch is scan-only);
// this is the histogram instance of fused_pass.cu with a key column, each
// nonzero weight added by a shared-memory atomic to bin
// key·d·nbins + dd·nbins + bin of its row.
//
// Slot g of either kernel is bitwise the dedicated fused_pass launch with
// valid_mask = valid · (key == g).  The moments kernel keeps fused_pass's
// CTA geometry: the same column ranges (_pass.pass_geometry, a function of
// the shapes), the same column order per thread, the warp butterfly and
// the warps summed in order (block_sum's order), one partial per (row,
// range) and sum_partials over the ranges in order, double for w_tot.
// The weights are fused_pass's (poisson_tile.cuh); the 0/1 key mask is
// exact, so w_g equals the masked run's weight.  Histogram counts are whole
// numbers, exact in f32 under any order of the atomics.
//
// Bound: operations.  The hash is 73 int32 operations a weight
// (poisson_tile.cuh), paid once for all G keys; the moments add G·(2d+1)
// f32 FMAs a weight (24 at G = 8, d = 1), the histogram one bin division
// per value and block of rows and one shared atomic per nonzero weight.
//
// Registers: a moments thread keeps rows · KG·(2·DC+1) accumulators (at
// most kGroupedAccs = 128; 128 took fused_kmeans.cu to 254 registers).
// A wide G·(2d+1) takes fewer rows of W per CTA (rows is a template
// constant of the instance), which costs no hash: the ranges do not depend
// on rows, and a weight is still drawn by one CTA.  Only past d > 4 or
// KG·(2·DC+1) > 128 does grid z cover DC columns and KG keys a chunk,
// paying the hash once per chunk.
//
// Grid: x = column ranges (whole RNG n-tiles, `tiles_per_cta` each),
// y = blocks of rows of W, z = (key chunk, column chunk) for moments.
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"
#include "moments_tile.cuh"
#include "poisson_tile.cuh"

namespace earl {

constexpr int kGroupedAccs = 128;

struct GroupedParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;  // padded rows, RNG tile shape, padded columns
  int d, G;
  const float* x;      // (np, d)
  const float* mask;   // (np) exact 0/1, or nullptr
  const float* keys;   // (np) key of each column, as f32 (padding: 0)
  int rows;            // rows of W per CTA
  int tiles_per_cta;
  int ranges;
  // moments: partials (Bp, ranges, G) and (Bp, ranges, G, d)
  float* part_w;
  float* part_s1;
  float* part_s2;
  // histogram: lo/hi (d,), output (Bp, G·d·nbins)
  int nbins;
  const float* lo;
  const float* hi;
  float* hist_out;
};

// Rows of W a CTA of the <DC, KG> moments instance takes.
template <int DC, int KG>
struct GroupedShape {
  static constexpr int kEntries = KG * (2 * DC + 1);  // a row's accumulators
  static constexpr int kRows = kGroupedAccs / kEntries < kMaxRows
                                   ? kGroupedAccs / kEntries
                                   : kMaxRows;
};

// The CTA's tile keys into shared memory, and each row's b-tile (0 or 1
// past i_first) and row within it, as fused_pass.cu derives them.
template <int R>
__device__ __forceinline__ void load_tile_keys(const GroupedParams& p,
                                               TileKey* keys, int t0, int t1,
                                               int r0, int* tsel, int* trow) {
  const int i_first = r0 / p.bb;
  for (int q = threadIdx.x; q < 2 * (t1 - t0); q += blockDim.x) {
    keys[q] = tile_key(p.seed, static_cast<uint32_t>(i_first + (q & 1)),
                       static_cast<uint32_t>(t0 + (q >> 1)));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = r0 + r;
    tsel[r] = b / p.bb - i_first;
    trow[r] = b - (b / p.bb) * p.bb;
  }
}

template <int DC, int KG>
__global__ void __launch_bounds__(kThreads)
grouped_moments_kernel(GroupedParams p) {
  constexpr int R = GroupedShape<DC, KG>::kRows;
  constexpr int E = GroupedShape<DC, KG>::kEntries;
  constexpr int S = 2 * DC + 1;  // a key's entries: w, s1[DC], s2[DC]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kWarps][R * E];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);

  const int range = blockIdx.x;
  const int r0 = blockIdx.y * R;
  const int ndc = (p.d + DC - 1) / DC;
  const int dz = (blockIdx.z % ndc) * DC;
  const int g0 = (blockIdx.z / ndc) * KG;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(R, p.Bp - r0);

  int tsel[R], trow[R];
  load_tile_keys<R>(p, keys, t0, t1, r0, tsel, trow);
  __syncthreads();

  float acc_w[R][KG], acc_s1[R][KG][DC], acc_s2[R][KG][DC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      acc_w[r][k] = 0.f;
#pragma unroll
      for (int q = 0; q < DC; ++q) acc_s1[r][k][q] = acc_s2[r][k][q] = 0.f;
    }
  }

  for (int t = t0; t < t1; ++t) {
    const TileKey* tk = keys + 2 * (t - t0);
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      const int64_t j = static_cast<int64_t>(t) * p.bn + c;
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        w[r] = r < nrows
                   ? implicit_weight(tk[tsel[r]],
                                     static_cast<uint32_t>(trow[r] * p.bn + c),
                                     j, p.n_valid, p.mask)
                   : 0.f;
      }
      const float key = p.keys[j];
      float xv[DC], x2[DC];
#pragma unroll
      for (int q = 0; q < DC; ++q) {
        xv[q] = dz + q < p.d ? p.x[j * p.d + dz + q] : 0.f;
        x2[q] = __fmul_rn(xv[q], xv[q]);
      }
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        // w · (key == g): w is a whole number >= 0, so the select is the
        // exact product, +0 off the key.
        const bool hit = key == static_cast<float>(g0 + k);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float wg = hit ? w[r] : 0.f;
          acc_w[r][k] = __fadd_rn(acc_w[r][k], wg);
#pragma unroll
          for (int q = 0; q < DC; ++q) {
            acc_s1[r][k][q] = __fmaf_rn(wg, xv[q], acc_s1[r][k][q]);
            acc_s2[r][k][q] = __fmaf_rn(wg, x2[q], acc_s2[r][k][q]);
          }
        }
      }
    }
  }

  // Each entry: the warp's fixed butterfly, then the warps in order from
  // 0.f, which is block_sum's order (moments_tile.cuh).
  const int warp = threadIdx.x >> 5;
  const bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int e = (r * KG + k) * S;
      const float sw = warp_sum(acc_w[r][k]);
      if (lane0) red[warp][e] = sw;
#pragma unroll
      for (int q = 0; q < DC; ++q) {
        const float s1 = warp_sum(acc_s1[r][k][q]);
        const float s2 = warp_sum(acc_s2[r][k][q]);
        if (lane0) {
          red[warp][e + 1 + q] = s1;
          red[warp][e + 1 + DC + q] = s2;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * E; idx += blockDim.x) {
    const int r = idx / E, k = (idx % E) / S, v = idx % S;
    const int g = g0 + k;
    if (r >= nrows || g >= p.G) continue;
    float s = 0.f;
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp][idx];
    const int64_t slot =
        (static_cast<int64_t>(r0 + r) * p.ranges + range) * p.G + g;
    if (v == 0) {
      if (dz == 0) p.part_w[slot] = s;
    } else {
      const int q = dz + (v - 1) % DC;
      float* part = v <= DC ? p.part_s1 : p.part_s2;
      if (q < p.d) part[slot * p.d + q] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_hist_kernel(GroupedParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  float* bins = reinterpret_cast<float*>(keys + 2 * p.tiles_per_cta);
  const int total = p.G * p.d * p.nbins;  // a row's bins

  const int range = blockIdx.x;
  const int r0 = blockIdx.y * p.rows;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(p.rows, p.Bp - r0);

  int tsel[kMaxRows], trow[kMaxRows];
  load_tile_keys<kMaxRows>(p, keys, t0, t1, r0, tsel, trow);
  for (int e = threadIdx.x; e < nrows * total; e += blockDim.x) bins[e] = 0.f;
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const TileKey* tk = keys + 2 * (t - t0);
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      const int64_t j = static_cast<int64_t>(t) * p.bn + c;
      // A key that is not a whole number in [0, G) (NaN included) is in
      // no slot, as (key == g) holds for no g.
      const float kf = p.keys[j];
      if (!(kf >= 0.f && kf < static_cast<float>(p.G))) continue;
      const int g = static_cast<int>(kf);
      if (static_cast<float>(g) != kf) continue;
      float w[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        w[r] = r < nrows
                   ? implicit_weight(tk[tsel[r]],
                                     static_cast<uint32_t>(trow[r] * p.bn + c),
                                     j, p.n_valid, p.mask)
                   : 0.f;
      }
      for (int dd = 0; dd < p.d; ++dd) {
        const float xv = p.x[j * p.d + dd];
        if (isnan(xv)) continue;  // NaN carries no mass
        const int bin = bin_index(xv, p.lo[dd], p.hi[dd], p.nbins);
        float* dst = bins + (g * p.d + dd) * p.nbins + bin;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (w[r] != 0.f) atomicAdd(dst + r * total, w[r]);
        }
      }
    }
  }
  __syncthreads();
  flush_bins(bins, nrows, total, p.hist_out, r0);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int DC, int KG>
int launch_moments(const GroupedParams& p, float* w_tot, float* s1,
                   float* s2, cudaStream_t stream) {
  using Shape = GroupedShape<DC, KG>;
  if (p.rows != Shape::kRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(TileKey) * 2 * p.tiles_per_cta;
  auto kernel = grouped_moments_kernel<DC, KG>;
  if (int e = set_smem(kernel, smem)) return e;
  const int zdim = ((p.d + DC - 1) / DC) * ((p.G + KG - 1) / KG);
  dim3 grid(p.ranges, (p.Bp + p.rows - 1) / p.rows, zdim);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  const int t = 256, nw = p.Bp * p.G, nd = nw * p.d;
  sum_partials<double><<<(nw + t - 1) / t, t, 0, stream>>>(
      p.part_w, w_tot, p.Bp, p.ranges, p.G);
  sum_partials<float><<<(nd + t - 1) / t, t, 0, stream>>>(
      p.part_s1, s1, p.Bp, p.ranges, p.G * p.d);
  sum_partials<float><<<(nd + t - 1) / t, t, 0, stream>>>(
      p.part_s2, s2, p.Bp, p.ranges, p.G * p.d);
  return static_cast<int>(cudaGetLastError());
}

// The <DC, KG> instance of _pass.grouped_geometry's (dc, kg).
int grouped_moments(const GroupedParams& p, int dc, int kg, float* w_tot,
                    float* s1, float* s2, cudaStream_t s) {
#define EARL_GROUPED_CASE(D, K) \
  if (dc == D && kg == K) return launch_moments<D, K>(p, w_tot, s1, s2, s);
  EARL_GROUPED_CASE(1, 1) EARL_GROUPED_CASE(1, 2) EARL_GROUPED_CASE(1, 4)
  EARL_GROUPED_CASE(1, 8) EARL_GROUPED_CASE(1, 16) EARL_GROUPED_CASE(1, 32)
  EARL_GROUPED_CASE(2, 1) EARL_GROUPED_CASE(2, 2) EARL_GROUPED_CASE(2, 4)
  EARL_GROUPED_CASE(2, 8) EARL_GROUPED_CASE(2, 16)
  EARL_GROUPED_CASE(4, 1) EARL_GROUPED_CASE(4, 2) EARL_GROUPED_CASE(4, 4)
  EARL_GROUPED_CASE(4, 8)
#undef EARL_GROUPED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int grouped_hist(const GroupedParams& p, cudaStream_t stream) {
  if (p.rows < 1 || p.rows > kMaxRows || p.nbins < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(TileKey) * 2 * p.tiles_per_cta +
                      sizeof(float) * p.rows * p.G * p.d * p.nbins;
  if (int e = set_smem(grouped_hist_kernel, smem)) return e;
  dim3 grid(p.ranges, (p.Bp + p.rows - 1) / p.rows, 1);
  grouped_hist_kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace earl

// Moments when part_w is not null (the <dc, kg> instance, `rows` its
// constant), else the keyed histogram.  Returns cudaGetLastError().
extern "C" int earl_fused_grouped(
    int32_t seed, int32_t n_valid, int Bp, int np, int bb, int bn, int d,
    int G, const void* x, const void* mask, const void* keys, int dc, int kg,
    int rows, int tiles_per_cta, int ranges, void* part_w, void* part_s1,
    void* part_s2, void* w_tot, void* s1, void* s2, int nbins,
    const void* lo, const void* hi, void* hist_out, void* stream) {
  // A CTA's rows must span at most two RNG b-tiles (fused_pass.cu).
  if (bb < earl::kMaxRows || d < 1 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::GroupedParams p{};
  p.seed = seed;
  p.n_valid = n_valid;
  p.Bp = Bp; p.bb = bb; p.bn = bn; p.np = np; p.d = d; p.G = G;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.keys = static_cast<const float*>(keys);
  p.rows = rows; p.tiles_per_cta = tiles_per_cta; p.ranges = ranges;
  p.part_w = static_cast<float*>(part_w);
  p.part_s1 = static_cast<float*>(part_s1);
  p.part_s2 = static_cast<float*>(part_s2);
  p.nbins = nbins;
  p.lo = static_cast<const float*>(lo);
  p.hi = static_cast<const float*>(hi);
  p.hist_out = static_cast<float*>(hist_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (part_w != nullptr) {
    return earl::grouped_moments(p, dc, kg, static_cast<float*>(w_tot),
                                 static_cast<float*>(s1),
                                 static_cast<float*>(s2), s);
  }
  return earl::grouped_hist(p, s);
}
