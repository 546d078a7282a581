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
// threefry2x32 (poisson_tile.cuh) and k·(d+1)+1 f32 FMAs, one into each of
// its row's accumulators; at the example's k = 5, d = 2 that is 73 integer
// operations against 16 FMAs, so the integer pipe bounds it.  x is read
// once per block of 8 rows.
//
// Grid and weights as fused_pass.cu: x = column ranges (whole RNG n-tiles,
// `tiles_per_cta` each, from _pass.pass_geometry), y = blocks of 8 rows of
// W, the CTA's tile keys in shared memory.  So the weights are bitwise
// those of every other fused path.  z = chunks of kEntChunk entries of a
// row's k·(d+1)+1 outputs, laid out [sums: cluster j, dim q at j·d + q |
// counts: k·d + j | inertia: k·(d+1)].
//
// Registers: a thread keeps 8 rows × kEntChunk = 128 accumulators.  A row
// needs k·(d+1)+1 of them, 16 at k = 5, d = 2, 145 at k = 16, d = 8; so a
// wide (k, d) takes more z chunks, each paying the hash again, and never
// spills an accumulator.  Per column a thread finds the cluster and
// min-d² once for its 8 rows (kmeans_tile.cuh, bitwise the plain
// version's), forms the chunk's values (x_q, 1 or min-d² where the entry's
// cluster is the column's, else 0) and adds w·value into every entry: a
// dense FMA with no branch on the data.
//
// No float atomics: a thread folds its columns in column order, the CTA
// sums each entry over its warps' butterflies in warp order, one partial
// per (row, range, entry), and sum_partials adds the ranges in order in
// double.  Counts are whole numbers below 2^24 per CTA (as w_tot in
// moments_tile.cuh), so they are the exact totals rounded once, bitwise
// the plain version's at any n.
#include <cstdint>
#include <cuda_runtime.h>

#include "kmeans_tile.cuh"
#include "moments_tile.cuh"
#include "poisson_tile.cuh"

namespace earl {

constexpr int kEntChunk = 16;  // accumulator entries of a row per CTA
// What entry e of a chunk sums, by the .y of its table entry; .x is the
// cluster it belongs to.  A dimension q >= 0 sums w·x_q.
constexpr int kCount = -1;     // w
constexpr int kInertia = -2;   // w·min-d², every cluster
constexpr int kPad = -3;       // nothing (past the last entry)

struct KMeansParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;   // padded rows, RNG tile shape, padded columns
  int d, k, entries;    // entries = k·(d+1)+1
  const float* x;       // (np, d)
  const float* mask;    // (np) exact 0/1, or nullptr
  const float* cent;    // (k, d)
  int tiles_per_cta;
  int ranges;
  float* part;          // (Bp, ranges, entries)
};

__global__ void __launch_bounds__(kThreads, 1)
fused_kmeans_kernel(KMeansParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kWarps][kMaxRows * kEntChunk];
  __shared__ int2 ent[kEntChunk];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);
  float* c_s = reinterpret_cast<float*>(keys + 2 * p.tiles_per_cta);
  float* cc_s = c_s + p.k * p.d;

  const int range = blockIdx.x;
  const int r0 = blockIdx.y * kMaxRows;
  const int e0 = blockIdx.z * kEntChunk;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(kMaxRows, p.Bp - r0);
  const int i_first = r0 / p.bb;

  for (int q = threadIdx.x; q < 2 * (t1 - t0); q += blockDim.x) {
    keys[q] = tile_key(p.seed, static_cast<uint32_t>(i_first + (q & 1)),
                       static_cast<uint32_t>(t0 + (q >> 1)));
  }
  for (int e = threadIdx.x; e < p.k * p.d; e += blockDim.x) {
    c_s[e] = p.cent[e];
  }
  if (threadIdx.x < kEntChunk) {
    const int idx = e0 + threadIdx.x, kd = p.k * p.d;
    int2 en = make_int2(0, kPad);
    if (idx < kd) {
      en = make_int2(idx / p.d, idx % p.d);
    } else if (idx < kd + p.k) {
      en = make_int2(idx - kd, kCount);
    } else if (idx == kd + p.k) {
      en = make_int2(0, kInertia);
    }
    ent[threadIdx.x] = en;
  }
  int tsel[kMaxRows], trow[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    const int b = r0 + r;
    tsel[r] = b / p.bb - i_first;
    trow[r] = b - (b / p.bb) * p.bb;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.k; j += blockDim.x) {
    cc_s[j] = sq_norm(c_s + j * p.d, p.d);
  }
  __syncthreads();

  float acc[kMaxRows][kEntChunk];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
    for (int e = 0; e < kEntChunk; ++e) acc[r][e] = 0.f;
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
      const float* xr = p.x + j * p.d;
      float best;
      const int jstar = nearest(xr, c_s, cc_s, p.d, p.k, best);
      float v[kEntChunk];
#pragma unroll
      for (int e = 0; e < kEntChunk; ++e) {
        const int2 en = ent[e];
        const float xq = xr[max(en.y, 0)];  // in bounds for every kind
        const float val = en.y >= 0 ? xq
                          : en.y == kCount ? 1.f
                          : en.y == kInertia ? best : 0.f;
        v[e] = (en.y == kInertia || en.x == jstar) ? val : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
        for (int e = 0; e < kEntChunk; ++e) {
          acc[r][e] = __fmaf_rn(w[r], v[e], acc[r][e]);
        }
      }
    }
  }

  // Each entry: the warp's fixed butterfly, then the warps in order.
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
    for (int e = 0; e < kEntChunk; ++e) {
      const float s = warp_sum(acc[r][e]);
      if ((threadIdx.x & 31) == 0) red[warp][r * kEntChunk + e] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < kMaxRows * kEntChunk) {
    const int r = threadIdx.x / kEntChunk, e = threadIdx.x % kEntChunk;
    if (r < nrows && e0 + e < p.entries) {
      float s = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) s += red[wp][threadIdx.x];
      p.part[(static_cast<int64_t>(r0 + r) * p.ranges + range) * p.entries +
             e0 + e] = s;
    }
  }
}

}  // namespace earl

// out (Bp, entries) = [sums (k, d) | counts (k) | inertia] per row of W;
// part (Bp, ranges, entries) is scratch.  Returns cudaGetLastError().
extern "C" int earl_fused_kmeans(int32_t seed, int32_t n_valid, int Bp,
                                 int np, int bb, int bn, int d, int k,
                                 const void* x, const void* mask,
                                 const void* cent, int tiles_per_cta,
                                 int ranges, void* part, void* out,
                                 void* stream) {
  // A CTA's 8 rows must span at most two RNG b-tiles (fused_pass.cu).
  if (bb < earl::kMaxRows || d < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::KMeansParams p{};
  p.seed = seed;
  p.n_valid = n_valid;
  p.Bp = Bp; p.bb = bb; p.bn = bn; p.np = np;
  p.d = d; p.k = k; p.entries = k * (d + 1) + 1;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.cent = static_cast<const float*>(cent);
  p.tiles_per_cta = tiles_per_cta;
  p.ranges = ranges;
  p.part = static_cast<float*>(part);
  const size_t smem = sizeof(earl::TileKey) * 2 * tiles_per_cta +
                      sizeof(float) * (k * d + k);
  auto kernel = earl::fused_kmeans_kernel;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(ranges, (Bp + earl::kMaxRows - 1) / earl::kMaxRows,
            (p.entries + earl::kEntChunk - 1) / earl::kEntChunk);
  kernel<<<grid, earl::kThreads, smem, s>>>(p);
  const int t = 256, total = Bp * p.entries;
  earl::sum_partials<double><<<(total + t - 1) / t, t, 0, s>>>(
      p.part, static_cast<float*>(out), Bp, ranges, p.entries);
  return static_cast<int>(cudaGetLastError());
}
