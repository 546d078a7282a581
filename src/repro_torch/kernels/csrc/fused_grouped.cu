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
// The reference has no TPU kernel for it (its grouped sketch is scan-only).
// It is key-major: a CTA owns a column range, a block of up to 8 rows of
// W and a chunk of KG keys, and keeps only those rows' KG·d·nbins bins in
// shared memory (64 KB at 8 rows, KG = 1, d = 1, nbins = 2048), so the
// bins no longer cap the rows and the limit that names block_bins is one
// key's d·nbins a row.  First keyed_index_kernel, one CTA a range, sorts
// the range's columns that carry a weight by key chunk into an index (a
// count, a scan and a scatter, once a call); then a histogram CTA walks
// its chunk's segment of it densely, one column a thread for all its
// rows: it hashes the column's weights, bins x once and adds each nonzero
// weight to bin (key - g0)·d·nbins + dd·nbins + bin of its row.  A
// (row, column) weight is drawn exactly once, by the one CTA whose chunk
// holds the column's key; columns past n_valid, with mask 0 or without a
// key in [0, G) are never hashed (their weight adds nothing).  Bins are
// u32, or f32 where the range's mask columns hold a value other than 0/1
// (hist_tile.cuh; the index pass raises the flag).  The index is built
// once a call because a scan of its range's keys in every CTA reads each
// key (row blocks × chunks) times (256 at the table's shape) and cost more
// than the hash it saved (PERF.md §6).  The geometry is
// _pass.keyed_hist_geometry's; grid x = range · chunks + key chunk, y =
// blocks of rows.
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
// Moments grid: x = column ranges (whole RNG n-tiles, `tiles_per_cta`
// each), y = blocks of rows of W, z = (key chunk, column chunk).
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
  const float* mask;   // (np), or nullptr
  const float* keys;   // (np) key of each column, as f32 (padding: 0)
  int rows;            // rows of W per CTA
  int kg;              // keys a chunk (histogram)
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
  int* index;          // scratch of KeyedHist.index_ints ints
};

// Rows of W a CTA of the <DC, KG> moments instance takes.
template <int DC, int KG>
struct GroupedShape {
  static constexpr int kEntries = KG * (2 * DC + 1);  // a row's accumulators
  static constexpr int kRows = kGroupedAccs / kEntries < kMaxRows
                                   ? kGroupedAccs / kEntries
                                   : kMaxRows;
};

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
  cta_tile_keys<R>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);
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

// Largest key chunk: an index entry packs the column within its tile (10
// bits, bn <= 512), the tile within the range (10 bits, at most 1024
// tiles) and the key within the chunk (11 bits).
constexpr int kMaxKeyChunk = 2048;

// The keyed histogram's scratch (`index`, KeyedHist.index_ints ints): the
// entries, np of them, range i's in [t0·bn, t1·bn) sorted by key chunk;
// then `ends`, ranges x chunks, the end of each chunk's segment (its start
// is the previous chunk's end, or t0·bn); then a flag a range, set when
// its mask columns hold a value other than 0/1.
struct KeyedIndex {
  int* entries;
  int* ends;
  int* frac;
};

__device__ __forceinline__ KeyedIndex keyed_index(const GroupedParams& p,
                                                  int chunks) {
  int* ends = p.index + p.np;
  return KeyedIndex{p.index, ends, ends + p.ranges * chunks};
}

// Key chunk of column j (-1: no weight to draw, as j is past n_valid, its
// mask is 0 or its key is not a whole number in [0, G)), and its entry.
__device__ __forceinline__ int column_chunk(const GroupedParams& p,
                                            int64_t j, int64_t c0,
                                            int* entry) {
  if (j >= p.n_valid) return -1;
  if (p.mask != nullptr && __ldg(p.mask + j) == 0.f) return -1;
  const int g = column_key(__ldg(p.keys + j), p.G);
  if (g < 0) return -1;
  const int ch = g / p.kg;
  const int rel = static_cast<int>(j - c0);
  const int tt = rel / p.bn;
  *entry = (rel - tt * p.bn) | tt << 10 | (g - ch * p.kg) << 20;
  return ch;
}

// One CTA a range: sorts the range's columns that carry a weight by key
// chunk into its segment of the entries (a count, a scan, a scatter; the
// order within a chunk is free, as the counts are whole numbers), and
// flags a mask value other than 0/1.  Atomics are aggregated over the
// lanes of a warp that share a chunk.
__global__ void __launch_bounds__(kThreads)
keyed_index_kernel(GroupedParams p) {
  __shared__ int tsum[kThreads];
  const int chunks = (p.G + p.kg - 1) / p.kg;
  const KeyedIndex ix = keyed_index(p, chunks);
  const int range = blockIdx.x;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int64_t c0 = static_cast<int64_t>(t0) * p.bn;
  const int64_t c1 = static_cast<int64_t>(t1) * p.bn;
  int* count = ix.ends + range * chunks;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  for (int e = threadIdx.x; e < chunks; e += blockDim.x) count[e] = 0;
  __syncthreads();
  bool frac = false;
  for (int64_t base = c0; base < c1; base += blockDim.x) {
    const int64_t j = base + threadIdx.x;
    int entry = 0, ch = -1;
    if (j < c1) {
      ch = column_chunk(p, j, c0, &entry);
      if (p.mask != nullptr && j < p.n_valid) {
        const float m = __ldg(p.mask + j);
        frac |= m != 0.f && m != 1.f;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, ch);
    if (ch >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(count + ch, __popc(peers));
    }
  }
  const int any = __syncthreads_or(frac);
  if (threadIdx.x == 0) ix.frac[range] = any;

  // exclusive scan of the counts from c0: a thread's block of chunks,
  // the blocks' sums scanned in shared memory
  const int per = (chunks + kThreads - 1) / kThreads;
  const int a = min(threadIdx.x * per, chunks);
  const int b = min(a + per, chunks);
  int sum = 0;
  for (int ch = a; ch < b; ++ch) sum += count[ch];
  tsum[threadIdx.x] = sum;
  __syncthreads();
  for (int o = 1; o < kThreads; o <<= 1) {
    const int v = threadIdx.x >= o ? tsum[threadIdx.x - o] : 0;
    __syncthreads();
    tsum[threadIdx.x] += v;
    __syncthreads();
  }
  int run = static_cast<int>(c0) + tsum[threadIdx.x] - sum;
  for (int ch = a; ch < b; ++ch) {
    const int v = count[ch];
    count[ch] = run;  // the start, advanced to the end by the scatter
    run += v;
  }
  __syncthreads();

  for (int64_t base = c0; base < c1; base += blockDim.x) {
    const int64_t j = base + threadIdx.x;
    int entry = 0, ch = -1;
    if (j < c1) ch = column_chunk(p, j, c0, &entry);
    const unsigned peers = __match_any_sync(0xffffffffu, ch);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (ch >= 0 && lane == leader) pos = atomicAdd(count + ch, __popc(peers));
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (ch >= 0) ix.entries[pos + __popc(peers & below)] = entry;
  }
}

// Hashes the column of one index entry for the CTA's rows and adds its
// weights.
__device__ __forceinline__ void add_entry(
    const GroupedParams& p, int entry, int t0, const TileKey* keys,
    const int (&tsel)[kMaxRows], const int (&trow)[kMaxRows], int nrows,
    uint32_t* bins, int stride, bool exact) {
  const int c = entry & 1023;
  const int tt = (entry >> 10) & 1023;
  const int k = entry >> 20;
  const int64_t j = static_cast<int64_t>(t0 + tt) * p.bn + c;
  const TileKey* tk = keys + 2 * tt;
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
    const float xv = __ldg(p.x + j * p.d + dd);
    if (isnan(xv)) continue;  // NaN carries no mass
    const int bin = bin_index(xv, __ldg(p.lo + dd), __ldg(p.hi + dd),
                              p.nbins);
    add_weights(bins, stride, (k * p.d + dd) * p.nbins + bin, w, exact);
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_hist_kernel(GroupedParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  uint32_t* bins = reinterpret_cast<uint32_t*>(keys + 2 * p.tiles_per_cta);

  const int chunks = (p.G + p.kg - 1) / p.kg;
  const KeyedIndex ix = keyed_index(p, chunks);
  const int range = blockIdx.x / chunks;
  const int chunk = blockIdx.x - range * chunks;
  const int g0 = chunk * p.kg;
  const int kgv = min(p.kg, p.G - g0);  // keys of this chunk
  const int slot = p.d * p.nbins;       // bins of a (row, key)
  const int stride = p.kg * slot;       // bins of a row in shared memory
  const int r0 = blockIdx.y * p.rows;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(p.rows, p.Bp - r0);
  const int* ends = ix.ends + range * chunks;
  const int e0 = chunk == 0 ? t0 * p.bn : ends[chunk - 1];
  const int e1 = ends[chunk];
  const bool exact = ix.frac[range] == 0;

  int tsel[kMaxRows], trow[kMaxRows];
  cta_tile_keys<kMaxRows>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);
  zero_bins(bins, nrows * stride);
  __syncthreads();
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    add_entry(p, __ldg(ix.entries + e), t0, keys, tsel, trow, nrows, bins,
              stride, exact);
  }
  __syncthreads();
  const int64_t total = static_cast<int64_t>(p.G) * slot;  // a row's bins
  flush_bins(bins, exact, nrows, kgv * slot, stride,
             p.hist_out + static_cast<int64_t>(r0) * total +
                 static_cast<int64_t>(g0) * slot,
             total);
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
  sum_fused_partials(p.part_w, p.part_s1, p.part_s2, w_tot, s1, s2, p.Bp,
                     p.ranges, p.G, p.G * p.d, stream);
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

// The keyed histogram at _pass.keyed_hist_geometry's (rows, kg, ranges,
// tiles_per_cta): the index pass, then the histogram pass, whose shared
// memory is KeyedHist.smem_bytes.
int grouped_hist(const GroupedParams& p, cudaStream_t stream) {
  if (p.rows < 1 || p.rows > kMaxRows || p.nbins < 1 || p.kg < 1 ||
      p.kg > kMaxKeyChunk || p.bn > 2 * kThreads ||
      p.tiles_per_cta > 1024 || p.index == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(TileKey) * 2 * p.tiles_per_cta +
                      sizeof(uint32_t) * p.rows * p.kg * p.d * p.nbins;
  if (int e = set_smem(grouped_hist_kernel, smem)) return e;
  const int chunks = (p.G + p.kg - 1) / p.kg;
  keyed_index_kernel<<<p.ranges, kThreads, 0, stream>>>(p);
  dim3 grid(p.ranges * chunks, (p.Bp + p.rows - 1) / p.rows, 1);
  grouped_hist_kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace earl

// Moments when part_w is not null (the <dc, kg> instance, `rows` its
// constant), else the keyed histogram (kg keys a chunk, dc unused, its
// scratch `index`).  Returns cudaGetLastError().
extern "C" int earl_fused_grouped(
    int32_t seed, int32_t n_valid, int Bp, int np, int bb, int bn, int d,
    int G, const void* x, const void* mask, const void* keys, int dc, int kg,
    int rows, int tiles_per_cta, int ranges, void* part_w, void* part_s1,
    void* part_s2, void* w_tot, void* s1, void* s2, int nbins,
    const void* lo, const void* hi, void* hist_out, void* index,
    void* stream) {
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
  p.rows = rows; p.kg = kg; p.tiles_per_cta = tiles_per_cta;
  p.ranges = ranges;
  p.part_w = static_cast<float*>(part_w);
  p.part_s1 = static_cast<float*>(part_s1);
  p.part_s2 = static_cast<float*>(part_s2);
  p.nbins = nbins;
  p.lo = static_cast<const float*>(lo);
  p.hi = static_cast<const float*>(hi);
  p.hist_out = static_cast<float*>(hist_out);
  p.index = static_cast<int*>(index);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (part_w != nullptr) {
    return earl::grouped_moments(p, dc, kg, static_cast<float*>(w_tot),
                                 static_cast<float*>(s1),
                                 static_cast<float*>(s2), s);
  }
  return earl::grouped_hist(p, s);
}
