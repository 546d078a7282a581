// GROUP BY passes over x with implicit Poisson(1) weights: one weight per
// (row of W, column), drawn once, routed to the slot of the column's key.
//
// grouped_moments_kernel<R, DC> replaces the TPU kernel
// repro/kernels/weighted_stats/kernel.py: fused_poisson_moments_grouped_kernel
// (_fpm_grouped_kernel) on its threefry path: w_tot (B, G) and s1, s2
// (B, G, d).  A thread keeps its slots in shared memory (slot_tile.cuh):
// for each of its R rows and each key of its CTA's chunk, w, s1 and s2 of
// DC columns.  A column adds w, w·x and w·x² to its own key's slots only,
// and a CTA hashes only the columns whose key its chunk holds, so each
// weight is drawn once per chunk of DC columns of x, whatever G.  Another
// key's non-finite x (or x²) turns the slot NaN, as w·0·x does in the
// masked run and in the reference's dense scan.
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
// column ranges (_pass.pass_geometry, a function of the shapes), the same
// column order per thread, the warp butterfly and the warps summed in
// order (block_sum's order), one partial per (row, range) and
// sum_partials over the ranges in order, double for w_tot.  The weights
// are fused_pass's (poisson_tile.cuh); the 0/1 key mask is exact, so a
// key's weight equals the masked run's, and a skipped column adds +0 there
// (slot_tile.cuh).  Rows a CTA and key chunks change no sum.  Histogram
// counts are whole numbers, exact in f32 under any order of the atomics.
//
// Bound: operations.  The hash is 73 int32 operations a weight
// (poisson_tile.cuh), paid once for all G keys; the moments add 2d+1
// shared read-add-writes a weight (3 at d = 1), whatever G, the histogram
// one bin division per value and block of rows and one shared atomic per
// nonzero weight.
//
// Moments geometry (_pass.grouped_geometry): a row's chunk of keys holds
// at most SLOT_FLOATS slots, kg·(2·DC+1); rows are added while three CTAs
// fit an SM (at least one row).
// Grid: x = blocks of R rows of W (fastest, so the CTAs of one column
// range run together and share its x and keys in L2), y = column ranges
// (whole RNG n-tiles, `tiles_per_cta` each), z = (key chunk, column
// chunk).
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"
#include "moments_tile.cuh"
#include "poisson_tile.cuh"
#include "slot_tile.cuh"

namespace earl {

struct GroupedParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;  // padded rows, RNG tile shape, padded columns
  int d, G;
  const float* x;      // (np, d)
  const float* mask;   // (np), or nullptr
  const float* keys;   // (np) key of each column, as f32 (padding: 0)
  int rows;            // rows of W per CTA
  int kg;              // keys a chunk
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

// The moments kernel: rows R of W a CTA (1, 2, 4 or 8) and DC columns of
// x, a template instance each; its key chunk (p.kg keys) is set at run
// time.  A thread keeps R·kg·(2·DC+1) slots (slot_tile.cuh), [row][key
// within the chunk][w, s1[DC], s2[DC]].  ONE: the chunk holds one key
// (G = 1), and the slots are registers, summed as kernel 2 sums its
// accumulators; no shared slots.
template <int R, int DC, bool ONE>
__global__ void __launch_bounds__(kThreads, 2)
grouped_moments_kernel(GroupedParams p) {
  constexpr int S = 2 * DC + 1;  // a key's slots: w, s1[DC], s2[DC]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  float* slots = reinterpret_cast<float*>(keys + 2 * p.tiles_per_cta);
  float reg[ONE ? R * S : 1];
  // slot s of row r and key kk (0 when ONE) of this thread
  auto slot = [&](int r, int kk, int s) -> float& {
    if constexpr (ONE) {
      return reg[r * S + s];
    } else {
      return slots[((r * p.kg + kk) * S + s) * kThreads + threadIdx.x];
    }
  };

  const int r0 = blockIdx.x * R;
  const int range = blockIdx.y;
  const int ndc = (p.d + DC - 1) / DC;
  const int dz = (blockIdx.z % ndc) * DC;
  const int g0 = (blockIdx.z / ndc) * p.kg;
  const int kg = p.kg;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(R, p.Bp - r0);
  const int row_slots = kg * S;  // a row's slots

  int tsel[R], trow[R];
  cta_tile_keys<R>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);
  if constexpr (ONE) {
#pragma unroll
    for (int e = 0; e < R * S; ++e) reg[e] = 0.f;
  } else {
    zero_slots(slots, R * row_slots);
  }
  __syncthreads();

  // Another key's non-finite x (x²) turns s1 (s2) NaN, as w·0·x does in
  // the dense fold (slot_tile.cuh); one key (ONE) folds w·(key == g)
  // densely, as kernel 2 does, and needs no note.
  PoisonNote nf1[DC], nf2[DC];
  for (int t = t0; t < t1; ++t) {
    const TileKey* tk = keys + 2 * (t - t0);
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      const int64_t j = static_cast<int64_t>(t) * p.bn + c;
      const float kf = __ldg(p.keys + j);
      const int g = ONE ? 0 : column_key(kf, p.G);  // -1: no key
      const int kk = g - g0;
      // (key == g0) is column_key(kf) == g0 for the one key g0 < G
      const bool hit = ONE ? kf == static_cast<float>(g0)
                           : g >= 0 && kk >= 0 && kk < kg;
      float xv[DC], x2[DC];
      bool finite = true;
#pragma unroll
      for (int q = 0; q < DC; ++q) {
        xv[q] = dz + q < p.d ? __ldg(p.x + j * p.d + dz + q) : 0.f;
        x2[q] = __fmul_rn(xv[q], xv[q]);
        finite = finite && isfinite(x2[q]);
      }
      if (!ONE && !finite) {
        const int key = g < 0 ? p.G : g;  // no key: a key no slot has
#pragma unroll
        for (int q = 0; q < DC; ++q) {
          if (!isfinite(xv[q])) nf1[q].note(key);
          if (!isfinite(x2[q])) nf2[q].note(key);
        }
      }
      if (!ONE && !hit) continue;  // another chunk's key: no hash
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        w[r] = r < nrows
                   ? implicit_weight(tk[tsel[r]],
                                     static_cast<uint32_t>(trow[r] * p.bn + c),
                                     j, p.n_valid, p.mask)
                   : 0.f;
        // w is a whole number >= 0, so the select is the exact w·0
        if (ONE && !hit) w[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float& aw = slot(r, ONE ? 0 : kk, 0);
        aw = __fadd_rn(aw, w[r]);
#pragma unroll
        for (int q = 0; q < DC; ++q) {
          float& a1 = slot(r, ONE ? 0 : kk, 1 + q);
          float& a2 = slot(r, ONE ? 0 : kk, 1 + DC + q);
          a1 = __fmaf_rn(w[r], xv[q], a1);
          a2 = __fmaf_rn(w[r], x2[q], a2);
        }
      }
    }
  }
  auto write = [&](int e, float total) {
    const int r = e / row_slots, kk = (e % row_slots) / S, v = e % S;
    const int g = g0 + kk;
    if (r >= nrows || g >= p.G) return;
    const int64_t slot =
        (static_cast<int64_t>(r0 + r) * p.ranges + range) * p.G + g;
    if (v == 0) {
      if (dz == 0) p.part_w[slot] = total;
    } else {
      const int q = dz + (v - 1) % DC;
      float* part = v <= DC ? p.part_s1 : p.part_s2;
      if (q < p.d) part[slot * p.d + q] = total;
    }
  };
  if constexpr (ONE) {
    // kernel 2's block sums from registers: each warp's butterfly, 32
    // slots at a time (slot_tile.cuh), then the warps in order from 0.f
    constexpr int kGroups = (R * S + 31) / 32;
    __shared__ float red[kWarps][kGroups * 32];
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int e = 0; e < kGroups * 32; e += 32) {
      float v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) v[u] = e + u < R * S ? reg[e + u] : 0.f;
      red[warp][e + (threadIdx.x & 31)] = warp_sums32(v);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * S; e += blockDim.x) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += red[w][e];
      write(e, total);
    }
  } else {
    bool noted = false;
#pragma unroll
    for (int q = 0; q < DC; ++q) {
      noted = noted || nf1[q].any() || nf2[q].any();
    }
    for (int r = 0; noted && r < R; ++r) {
      for (int kk = 0; kk < kg; ++kk) {
        float* s = slots + (r * row_slots + kk * S) * kThreads + threadIdx.x;
#pragma unroll
        for (int q = 0; q < DC; ++q) {
          if (nf1[q].poisons(g0 + kk)) s[(1 + q) * kThreads] = poison_nan();
          if (nf2[q].poisons(g0 + kk)) {
            s[(1 + DC + q) * kThreads] = poison_nan();
          }
        }
      }
    }
    reduce_slots(slots, R * row_slots, write);
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

template <int R, int DC, bool ONE>
int launch_moments(const GroupedParams& p, float* w_tot, float* s1,
                   float* s2, cudaStream_t stream) {
  const size_t smem =
      sizeof(TileKey) * 2 * p.tiles_per_cta +
      (ONE ? 0 : sizeof(float) * kThreads * R * p.kg * (2 * DC + 1));
  auto kernel = grouped_moments_kernel<R, DC, ONE>;
  if (int e = set_smem(kernel, smem)) return e;
  const int zdim = ((p.d + DC - 1) / DC) * ((p.G + p.kg - 1) / p.kg);
  dim3 grid((p.Bp + R - 1) / R, p.ranges, zdim);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  sum_fused_partials(p.part_w, p.part_s1, p.part_s2, w_tot, s1, s2, p.Bp,
                     p.ranges, p.G, p.G * p.d, stream);
  return static_cast<int>(cudaGetLastError());
}

// One key a chunk keeps its slots in registers where R·(2·DC+1) <= 40
// (more spill under the two-CTA bound).
template <int R, int DC>
int launch_rows(const GroupedParams& p, float* w_tot, float* s1, float* s2,
                cudaStream_t stream) {
  if constexpr (R * (2 * DC + 1) <= 40) {
    if (p.kg == 1) {
      return launch_moments<R, DC, true>(p, w_tot, s1, s2, stream);
    }
  }
  return launch_moments<R, DC, false>(p, w_tot, s1, s2, stream);
}

// The <rows, dc> instance of _pass.grouped_geometry, p.kg keys a chunk.
int grouped_moments(const GroupedParams& p, int dc, float* w_tot,
                    float* s1, float* s2, cudaStream_t s) {
  if (p.kg < 1) return static_cast<int>(cudaErrorInvalidValue);
#define EARL_GROUPED_CASE(R, D) \
  if (p.rows == R && dc == D) return launch_rows<R, D>(p, w_tot, s1, s2, s);
  EARL_GROUPED_CASE(1, 1) EARL_GROUPED_CASE(2, 1) EARL_GROUPED_CASE(4, 1)
  EARL_GROUPED_CASE(8, 1) EARL_GROUPED_CASE(1, 2) EARL_GROUPED_CASE(2, 2)
  EARL_GROUPED_CASE(4, 2) EARL_GROUPED_CASE(8, 2) EARL_GROUPED_CASE(1, 4)
  EARL_GROUPED_CASE(2, 4) EARL_GROUPED_CASE(4, 4) EARL_GROUPED_CASE(8, 4)
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
    return earl::grouped_moments(p, dc, static_cast<float*>(w_tot),
                                 static_cast<float*>(s1),
                                 static_cast<float*>(s2), s);
  }
  return earl::grouped_hist(p, s);
}
