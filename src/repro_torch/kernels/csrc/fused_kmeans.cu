// Bootstrap over k-means: for B resamples under implicit Poisson(1)
// weights W (never stored), sums (B, k, d), counts (B, k), inertia (B).
//
// Replaces repro/kernels/kmeans_assign/kernel.py:
// fused_poisson_kmeans_kernel (_fpk_kernel, with _assign_tile), on its
// threefry path, with n_valid and the validity mask.  The TPU kernel
// contracts a (bB, bn) weight tile against a (bn, k) one-hot and k
// cluster-masked copies of x on the MXU.
//
// Bound: operations.  Each weight costs the 73 int32 operations of one
// threefry2x32 (poisson_tile.cuh); the rest is d+1 shared read-add-writes
// a weight (its cluster's d sums and count) and one FMA (the inertia).
//
// Two passes a call.  fused_kmeans_assign, one thread a column, finds
// each column's cluster j* and min-d² once (nearest() in kmeans_tile.cuh,
// bitwise the plain version's assign_tile) into a scratch of 8 bytes a
// column that the wrapper allocates: j*, with bit 30 set where a value of
// the column is not finite, and min-d².  (On a grid of few CTAs a column,
// as at the example's B = 24, n = 8,000, the bootstrap CTAs assign their
// columns themselves and the launch is saved; see kmeans_assign/ops.py.)
// Then fused_kmeans_kernel<R, DC> draws the weights.  Grid and weights as fused_pass.cu: a CTA takes R
// rows of W (grid x, fastest, so the CTAs of one column range share its x
// and assignments in L2) over one column range (grid y: whole RNG n-tiles,
// `tiles_per_cta` each, from _pass.pass_geometry), so the weights are
// bitwise those of every other fused path; grid z = (cluster chunk of kc
// clusters, chunk of DC columns of x).  A thread keeps, for each of its
// rows and each cluster of its chunk, DC sums and the count in shared
// slots (slot_tile.cuh), and a row's inertia in a register; a column adds
// w·x_q and w to the slots of its own cluster and w·min-d² to the
// inertia, so a wide (k, d) costs more slots, not
// more FMAs a weight, and a CTA hashes only the columns whose cluster its
// chunk holds: a weight is drawn once per chunk of DC columns of x.
// Counts and inertia come from the CTAs of the first column chunk.  The
// geometry is _pass.kmeans_geometry's (a row holds at most SLOT_FLOATS
// slots; rows are added while three CTAs fit an SM).
//
// Non-finite x: the plain version's cluster-masked copy of x is 0·x_q for
// every other cluster, NaN for x_q = ±inf or NaN, which poisons that
// cluster's sums of dimension q in every row; the skipped columns are
// noted per dimension and turn those slots NaN (slot_tile.cuh).  Its own
// cluster adds w·x_q, NaN where w = 0.
//
// No float atomics: a thread folds its columns in column order, the CTA
// sums each slot over its warps' butterflies in warp order, one partial
// per (row, range, slot), and kmeans_finish adds the ranges in order in
// double (the inertia, one a row and cluster chunk: over the ranges, then
// the chunks in order).  Counts are whole numbers below 2^24 per CTA (as w_tot in
// moments_tile.cuh), so they are the exact totals rounded once, bitwise
// the plain version's at any n.
#include <cstdint>
#include <cuda_runtime.h>

#include "kmeans_tile.cuh"
#include "moments_tile.cuh"
#include "poisson_tile.cuh"
#include "slot_tile.cuh"

namespace earl {

// Scratch word of a column: j* in the low bits, kNonFinite where one of
// its d values is ±inf or NaN.
constexpr int kNonFinite = 1 << 30;
constexpr int kClusterBits = kNonFinite - 1;

struct KMeansParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;   // padded rows, RNG tile shape, padded columns
  int d, k;
  const float* x;       // (np, d)
  const float* mask;    // (np) exact 0/1, or nullptr
  const float* cent;    // (k, d)
  int kc;               // clusters a chunk
  int tiles_per_cta;
  int ranges;
  int2* asg;            // (np): j* | kNonFinite, min-d² as bits
  float* part;          // (Bp, ranges, k·(d+1) + cluster chunks)
};

// The centroids and their squared norms into shared memory (k·d, then
// k floats at c_s).  The caller synchronizes before reading them.
__device__ __forceinline__ void load_centroids(const KMeansParams& p,
                                               float* c_s) {
  for (int e = threadIdx.x; e < p.k * p.d; e += blockDim.x) {
    c_s[e] = p.cent[e];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.k; j += blockDim.x) {
    c_s[p.k * p.d + j] = sq_norm(c_s + j * p.d, p.d);
  }
}

// The scratch word of the column at xr: nearest() against the centroids
// in shared memory, and whether a value is not finite.
__device__ __forceinline__ int2 assign_column(const float* xr,
                                              const float* c_s, int d,
                                              int k) {
  float best;
  int tag = nearest(xr, c_s, c_s + k * d, d, k, best);
  for (int q = 0; q < d; ++q) {
    if (!isfinite(xr[q])) tag |= kNonFinite;
  }
  return make_int2(tag, __float_as_int(best));
}

// One thread a column.
__global__ void __launch_bounds__(kThreads)
fused_kmeans_assign(KMeansParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* c_s = reinterpret_cast<float*>(smem_raw);
  load_centroids(p, c_s);
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j < p.np) p.asg[j] = assign_column(p.x + j * p.d, c_s, p.d, p.k);
}

// The bootstrap pass: a thread's slots are [row][cluster within the
// chunk][sum of DC columns, count], then each row's inertia, which a
// register gathers over the clusters of the chunk.  Without a scratch (p.asg
// null: a grid of few CTAs a column, where one more launch costs more
// than assigning each column in each of them) a CTA assigns its columns
// itself, with the same nearest(), from centroids after its slots.
template <int R, int DC>
__global__ void __launch_bounds__(kThreads, 2)
fused_kmeans_kernel(KMeansParams p) {
  constexpr int S = DC + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  float* slots = reinterpret_cast<float*>(keys + 2 * p.tiles_per_cta);
  float* c_s = slots + kThreads * R * (p.kc * S + 1);

  const int r0 = blockIdx.x * R;
  const int range = blockIdx.y;
  const int ndc = (p.d + DC - 1) / DC;
  const int dz = (blockIdx.z % ndc) * DC;
  const int c0 = (blockIdx.z / ndc) * p.kc;
  const bool lead = dz == 0;  // counts and inertia
  const int kc = p.kc;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(R, p.Bp - r0);
  const int row_slots = kc * S;

  int tsel[R], trow[R];
  cta_tile_keys<R>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);
  const int count = R * row_slots + R;  // and the R inertias
  zero_slots(slots, count);
  if (p.asg == nullptr) load_centroids(p, c_s);
  __syncthreads();

  float inertia[R];
#pragma unroll
  for (int r = 0; r < R; ++r) inertia[r] = 0.f;
  PoisonNote nf[DC];
  for (int t = t0; t < t1; ++t) {
    const TileKey* tk = keys + 2 * (t - t0);
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      const int64_t j = static_cast<int64_t>(t) * p.bn + c;
      const int2 a = p.asg != nullptr
                         ? __ldg(p.asg + j)
                         : assign_column(p.x + j * p.d, c_s, p.d, p.k);
      const int js = a.x & kClusterBits;
      const int kk = js - c0;
      const bool mine = kk >= 0 && kk < kc;
      const bool nonfinite = (a.x & kNonFinite) != 0;
      if (!mine && !nonfinite) continue;
      float xv[DC];
#pragma unroll
      for (int q = 0; q < DC; ++q) {
        xv[q] = dz + q < p.d ? __ldg(p.x + j * p.d + dz + q) : 0.f;
        if (nonfinite && !isfinite(xv[q])) nf[q].note(js);
      }
      if (!mine) continue;  // another chunk's cluster: no hash
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        w[r] = r < nrows
                   ? implicit_weight(tk[tsel[r]],
                                     static_cast<uint32_t>(trow[r] * p.bn + c),
                                     j, p.n_valid, p.mask)
                   : 0.f;
      }
      const float best = __int_as_float(a.y);
      float* s = slots + kk * S * kThreads + threadIdx.x;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* sr = s + r * row_slots * kThreads;
#pragma unroll
        for (int q = 0; q < DC; ++q) {
          sr[q * kThreads] = __fmaf_rn(w[r], xv[q], sr[q * kThreads]);
        }
        if (lead) {
          float* cnt = sr + DC * kThreads;
          *cnt = __fadd_rn(*cnt, w[r]);
          inertia[r] = __fmaf_rn(w[r], best, inertia[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    slots[(R * row_slots + r) * kThreads + threadIdx.x] = inertia[r];
  }

  // Another cluster's non-finite value: NaN (slot_tile.cuh).
  bool noted = false;
#pragma unroll
  for (int q = 0; q < DC; ++q) noted = noted || nf[q].any();
  for (int r = 0; noted && r < R; ++r) {
    for (int kk = 0; kk < kc; ++kk) {
      float* s = slots + (r * row_slots + kk * S) * kThreads + threadIdx.x;
#pragma unroll
      for (int q = 0; q < DC; ++q) {
        if (nf[q].poisons(c0 + kk)) s[q * kThreads] = poison_nan();
      }
    }
  }
  const int kd = p.k * p.d;
  const int pe = kd + p.k + (p.k + kc - 1) / kc;
  reduce_slots(slots, count, [&](int e, float total) {
    const bool ine = e >= R * row_slots;
    const int r = ine ? e - R * row_slots : e / row_slots;
    const int kk = (e % row_slots) / S, v = e % S;
    const int cl = c0 + kk;
    if (r >= nrows || (!ine && cl >= p.k)) return;
    float* part =
        p.part + (static_cast<int64_t>(r0 + r) * p.ranges + range) * pe;
    if (ine) {
      if (lead) part[kd + p.k + c0 / kc] = total;
    } else if (v < DC) {
      if (dz + v < p.d) part[cl * p.d + dz + v] = total;
    } else if (lead) {
      part[kd + cl] = total;
    }
  });
}

// out (Bp, k·(d+1)+1) from part (Bp, ranges, k·(d+1) + chunks): the sums
// and counts over the ranges in order, the inertia over the ranges and
// then the cluster chunks in order, in double.
__global__ void kmeans_finish(const float* __restrict__ part,
                              float* __restrict__ out, int rows, int ranges,
                              int k, int d, int chunks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int entries = k * (d + 1) + 1, pe = k * (d + 1) + chunks;
  if (idx >= rows * entries) return;
  const int b = idx / entries, e = idx - b * entries;
  const float* pb = part + static_cast<int64_t>(b) * ranges * pe;
  double s = 0.0;
  if (e < k * (d + 1)) {
    for (int r = 0; r < ranges; ++r) s += pb[r * pe + e];
  } else {
    for (int ch = 0; ch < chunks; ++ch) {
      double sc = 0.0;
      for (int r = 0; r < ranges; ++r) sc += pb[r * pe + e + ch];
      s += sc;
    }
  }
  out[idx] = static_cast<float>(s);
}

template <int R, int DC>
int launch_kmeans(const KMeansParams& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(TileKey) * 2 * p.tiles_per_cta +
      sizeof(float) * kThreads * R * (p.kc * (DC + 1) + 1) +
      (p.asg == nullptr ? sizeof(float) * p.k * (p.d + 1) : 0);
  auto kernel = fused_kmeans_kernel<R, DC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int zdim = ((p.d + DC - 1) / DC) * ((p.k + p.kc - 1) / p.kc);
  dim3 grid((p.Bp + R - 1) / R, p.ranges, zdim);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The <rows, dc> instance of _pass.kmeans_geometry.
int kmeans_pass(const KMeansParams& p, int rows, int dc, cudaStream_t s) {
#define EARL_KMEANS_CASE(R, D) \
  if (rows == R && dc == D) return launch_kmeans<R, D>(p, s);
  EARL_KMEANS_CASE(1, 1) EARL_KMEANS_CASE(2, 1) EARL_KMEANS_CASE(4, 1)
  EARL_KMEANS_CASE(8, 1) EARL_KMEANS_CASE(1, 2) EARL_KMEANS_CASE(2, 2)
  EARL_KMEANS_CASE(4, 2) EARL_KMEANS_CASE(8, 2) EARL_KMEANS_CASE(1, 4)
  EARL_KMEANS_CASE(2, 4) EARL_KMEANS_CASE(4, 4) EARL_KMEANS_CASE(8, 4)
#undef EARL_KMEANS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace earl

// out (Bp, entries) = [sums (k, d) | counts (k) | inertia] per row of W;
// asg (np int2, or null: each CTA assigns its columns) and part (Bp,
// ranges, k·(d+1) + cluster chunks) are scratch.  rows, dc and kc are
// _pass.kmeans_geometry's.  Returns cudaGetLastError().
extern "C" int earl_fused_kmeans(int32_t seed, int32_t n_valid, int Bp,
                                 int np, int bb, int bn, int d, int k,
                                 const void* x, const void* mask,
                                 const void* cent, int rows, int dc, int kc,
                                 int tiles_per_cta, int ranges, void* asg,
                                 void* part, void* out, void* stream) {
  // A CTA's rows must span at most two RNG b-tiles (fused_pass.cu).
  if (bb < earl::kMaxRows || d < 1 || k < 1 || kc < 1 ||
      k > earl::kClusterBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::KMeansParams p{};
  p.seed = seed;
  p.n_valid = n_valid;
  p.Bp = Bp; p.bb = bb; p.bn = bn; p.np = np;
  p.d = d; p.k = k; p.kc = kc;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.cent = static_cast<const float*>(cent);
  p.tiles_per_cta = tiles_per_cta;
  p.ranges = ranges;
  p.asg = static_cast<int2*>(asg);
  p.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t csmem = sizeof(float) * k * (d + 1);
  if (csmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        earl::fused_kmeans_assign,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(csmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int t = earl::kThreads;
  if (asg != nullptr) {
    earl::fused_kmeans_assign<<<(np + t - 1) / t, t, csmem, s>>>(p);
  }
  if (int e = earl::kmeans_pass(p, rows, dc, s)) return e;
  const int total = Bp * (k * (d + 1) + 1);
  earl::kmeans_finish<<<(total + t - 1) / t, t, 0, s>>>(
      p.part, static_cast<float*>(out), Bp, ranges, k, d, (k + kc - 1) / kc);
  return static_cast<int>(cudaGetLastError());
}
