// One weighted Lloyd assignment pass: sums (k, d), counts (k), inertia ().
//
// Replaces repro/kernels/kmeans_assign/kernel.py: kmeans_assign_kernel
// (_ka_kernel, with _assign_tile).  The TPU kernel computes a (bn, k)
// distance tile on the MXU and contracts a one-hot against x·w; here each
// thread takes a point at a time, finds its cluster with the d² of
// kmeans_tile.cuh (bitwise the plain version's), and adds w·x, w and
// w·min-d² to that cluster's accumulators.  Neither the (n, k) distances
// nor the one-hot exist anywhere.
//
// Bound: bytes.  x and w are read once (4·(d+1) bytes a point); the
// assignment is k·(2d+3) f32 operations a point, below the card's
// 20 operations a byte for every k·d the path uses (k = 5, d = 2).  At the
// path's n = 400,000 the bytes take 1.4 µs, so the launch, the CTAs' one
// wave and the sum across CTAs set the time: one launch a call.
//
// Two layouts, chosen by (k, d) alone (ops.assign_geometry mirrors it):
// - assign_regs<D, 8> for d <= 4 and k <= 8 (the path's k = 5, d = 2): a
//   thread's k·(d+1)+1 accumulators (at most 8·5+1) and the centroids live
//   in registers; a point adds the plain version's one-hot row times w (w
//   for its cluster, 0 for the others) into every cluster's sums and
//   count, every register index a constant.  A thread loads
//   4 consecutive points at once (a quad): w by one float4 and x by d
//   float4s when x and w are 16-byte aligned (the CTA's column range
//   starts on a point that is a multiple of 4), scalar loads otherwise and
//   at the ragged end; it issues the loads of 4 quads before it folds
//   them.  A CTA takes at least 12 points a thread and the grid at most
//   two CTAs an SM (ops.assign_geometry): few partials for the last CTA
//   to sum, few tickets, each thread's loads in flight together.  The CTA
//   sums its threads 32 entries a butterfly (warp_sums32), then its warps
//   in order.
// - assign_slots for a wider (k, d): the k·(d+1)+1 accumulators of each
//   thread in shared memory, [entry][thread], so a warp's updates hit 32
//   banks; one point at a time; each entry summed by one warp.
//
// One launch, no float atomics: a CTA folds a fixed column range (a
// function of the shapes, from ops.assign_geometry) in a fixed order and
// writes one partial per (range, entry); then a __threadfence() and an
// integer ticket elect the last CTA to finish, which sums the partials in
// double in a fixed order (lane l of a warp a contiguous run of ranges in
// range order, then the warp's fixed butterfly; a warp four entries at
// once, so their loads are in flight together) and resets the ticket for
// the next launch.  Two launches give the same bits.  Counts of whole
// weights are exact in f32 within a CTA and in double across CTAs, so they
// are the exact totals rounded once, as the plain version's.  With no
// weights (w null) every weight is 1.f: the same arithmetic as unit
// weights, bitwise.
//
// Non-finite x: the plain version contracts the one-hot against x·w, so
// every other cluster's sum of dimension q gets 0·(x_q·w), NaN for x_q =
// ±inf or NaN, whatever w is (0 included); the point's own cluster adds
// w·x_q (NaN at w = 0).  The register layout adds 0·x_q into the other
// clusters, which is that NaN (and nothing for a finite x_q); it measured
// 9% faster than selects with notes (PERF.md §6).  The shared-slot layout
// touches only the point's own cluster's slots, so a thread notes, per
// dimension, the clusters of the non-finite values it folded (PoisonNote,
// slot_tile.cuh) and, if it noted any, turns every other cluster's slot
// of that dimension NaN before the block sums; a thread that noted
// nothing skips that loop.
#include <cstdint>
#include <cuda_runtime.h>

#include "kmeans_tile.cuh"
#include "moments_tile.cuh"
#include "slot_tile.cuh"

namespace {

// The register layout's cluster slots and widest d (ops.REG_CLUSTERS,
// ops.REG_MAX_DIM).
constexpr int kRegClusters = 8;
constexpr int kRegMaxDim = 4;
// Points a thread loads at once in the register layout (a quad), and the
// quads whose loads it issues together before it folds them.
constexpr int kQuad = 4;
constexpr int kQuadsAtOnce = 4;
// Entries a warp of the last CTA sums at once (finish).
constexpr int kFinishEntries = 4;

struct AssignArgs {
  int n, d, k;
  const float* x;     // (n, d)
  const float* w;     // (n), or null: every weight 1
  const float* cent;  // (k, d)
  int cols;           // points a CTA folds
  int ranges;         // CTAs
  float* part;        // (ranges, entries)
  unsigned* ticket;   // 0 between launches
  float* out;         // (entries)
  bool vec;           // x, w 16-byte aligned: float4 loads
};

// After each CTA wrote its `entries` partials: the last CTA to arrive
// sums them over the ranges, in double, in a fixed order, into out, and
// resets the ticket.  Every thread of the CTA must call it.
__device__ __forceinline__ void finish(const AssignArgs& p, int entries) {
  __shared__ int last;
  __threadfence();  // this thread's partials, before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(p.ticket, 1u) == gridDim.x - 1 ? 1 : 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = (p.ranges + 31) / 32;
  const int r0 = min(lane * per, p.ranges), r1 = min(r0 + per, p.ranges);
  // warp w sums entries e0 + j·warps, j < kFinishEntries, together, so a
  // lane has their loads of a range in flight at once
  for (int e0 = warp; e0 < entries; e0 += warps * kFinishEntries) {
    double s[kFinishEntries];
#pragma unroll
    for (int j = 0; j < kFinishEntries; ++j) s[j] = 0.0;
    for (int r = r0; r < r1; ++r) {
      const float* row = p.part + static_cast<int64_t>(r) * entries;
#pragma unroll
      for (int j = 0; j < kFinishEntries; ++j) {
        const int e = e0 + j * warps;
        if (e < entries) s[j] += static_cast<double>(__ldcg(row + e));
      }
    }
#pragma unroll
    for (int j = 0; j < kFinishEntries; ++j) {
      for (int o = 16; o > 0; o >>= 1) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      const int e = e0 + j * warps;
      if (lane == 0 && e < entries) p.out[e] = static_cast<float>(s[j]);
    }
  }
  if (threadIdx.x == 0) *p.ticket = 0u;
}

// ---------------------------------------------------------------------------
// register layout: d = D <= 4, k <= KM = 8
// ---------------------------------------------------------------------------
// nearest() (kmeans_tile.cuh) over centroids held in registers: the same
// operations in the same order, so the same cluster and d², bitwise.
template <int D, int KM>
__device__ __forceinline__ int nearest_regs(const float* xr,
                                            const float (&c)[KM][D],
                                            const float (&cc)[KM], int k,
                                            float& best) {
  float xx = __fmul_rn(xr[0], xr[0]);
#pragma unroll
  for (int q = 1; q < D; ++q) xx = __fadd_rn(xx, __fmul_rn(xr[q], xr[q]));
  int jstar = 0;
  best = 0.f;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      float xc = __fmul_rn(xr[0], c[j][0]);
#pragma unroll
      for (int q = 1; q < D; ++q) xc = __fadd_rn(xc, __fmul_rn(xr[q], c[j][q]));
      float d2 = __fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, xc)), cc[j]);
      d2 = d2 < 0.f ? 0.f : d2;
      if (j == 0 || d2 < best || (isnan(d2) && !isnan(best))) {
        best = d2;
        jstar = j;
      }
    }
  }
  return jstar;
}

// Quad i .. i + 3 of x and w into registers: by float4 when aligned and
// whole, else scalar loads (weight 0 past c1; weight 1 without w).
template <int D>
__device__ __forceinline__ void load_quad(const AssignArgs& p, int64_t i,
                                          int64_t c1, float (&xs)[kQuad * D],
                                          float (&ws)[kQuad]) {
  if (p.vec && i + kQuad <= c1) {
    const float4* x4 = reinterpret_cast<const float4*>(p.x + i * D);
#pragma unroll
    for (int v = 0; v < D; ++v) {
      const float4 t = __ldg(x4 + v);
      xs[4 * v] = t.x;
      xs[4 * v + 1] = t.y;
      xs[4 * v + 2] = t.z;
      xs[4 * v + 3] = t.w;
    }
    if (p.w != nullptr) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p.w + i));
      ws[0] = t.x;
      ws[1] = t.y;
      ws[2] = t.z;
      ws[3] = t.w;
    } else {
#pragma unroll
      for (int u = 0; u < kQuad; ++u) ws[u] = 1.f;
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    const bool ok = i + u < c1;
#pragma unroll
    for (int q = 0; q < D; ++q) {
      xs[u * D + q] = ok ? __ldg(p.x + (i + u) * D + q) : 0.f;
    }
    ws[u] = !ok ? 0.f : p.w != nullptr ? __ldg(p.w + i + u) : 1.f;
  }
}

// One point into the accumulators: the plain version's one-hot row times
// w, w or 0, into every cluster's sums (w_j·x_q) and count (w_j), and
// w·min-d² into the inertia.  0·x_q adds nothing to another cluster's sum
// for a finite x_q (the sum starts at +0 and is never -0) and makes it NaN
// for ±inf or NaN, as in the plain version, so no notes are needed.
template <int D, int KM>
__device__ __forceinline__ void fold_point(
    const float* xr, float wv, const float (&c)[KM][D], const float (&cc)[KM],
    int k, float (&acc)[KM * (D + 1) + 1]) {
  float best;
  const int js = nearest_regs<D, KM>(xr, c, cc, k, best);
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {  // uniform: the slots past k stay 0
      const float wj = j == js ? wv : 0.f;
#pragma unroll
      for (int q = 0; q < D; ++q) {
        acc[j * D + q] = __fmaf_rn(wj, xr[q], acc[j * D + q]);
      }
      acc[KM * D + j] = __fadd_rn(acc[KM * D + j], wj);
    }
  }
  acc[KM * (D + 1)] = __fmaf_rn(wv, best, acc[KM * (D + 1)]);
}

template <int D, int KM>
__global__ void __launch_bounds__(earl::kThreads, 1)
assign_regs(AssignArgs p) {
  constexpr int E = KM * (D + 1) + 1;  // [sums (KM, D) | counts | inertia]
  __shared__ float c_s[KM * D];
  __shared__ float red[earl::kWarps][E];
  // a thread's quads are i, i + 4·T, i + 8·T, ... in order; it issues the
  // loads of kQuadsAtOnce of them, then folds them.  The first loads go
  // out before the centroids are read, so the two wait together.
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * p.cols;
  const int64_t c1 = min(c0 + p.cols, static_cast<int64_t>(p.n));
  const int64_t step = kQuad * blockDim.x;
  int64_t i0 = c0 + kQuad * threadIdx.x;
  float xs[kQuadsAtOnce][kQuad * D], ws[kQuadsAtOnce][kQuad];
#pragma unroll
  for (int b = 0; b < kQuadsAtOnce; ++b) {
    load_quad<D>(p, i0 + b * step, c1, xs[b], ws[b]);
  }
  for (int e = threadIdx.x; e < KM * D; e += blockDim.x) {
    c_s[e] = e < p.k * D ? p.cent[e] : 0.f;
  }
  __syncthreads();
  float c[KM][D], cc[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
#pragma unroll
    for (int q = 0; q < D; ++q) c[j][q] = c_s[j * D + q];
    cc[j] = earl::sq_norm(c_s + j * D, D);
  }
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  while (i0 < c1) {
#pragma unroll
    for (int b = 0; b < kQuadsAtOnce; ++b) {
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        if (i0 + b * step + u >= c1) break;
        fold_point<D, KM>(xs[b] + u * D, ws[b][u], c, cc, p.k, acc);
      }
    }
    i0 += kQuadsAtOnce * step;
    if (i0 >= c1) break;
#pragma unroll
    for (int b = 0; b < kQuadsAtOnce; ++b) {
      load_quad<D>(p, i0 + b * step, c1, xs[b], ws[b]);
    }
  }

  // block sums: 32 entries a butterfly, then the warps in order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int e0 = 0; e0 < E; e0 += 32) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) v[u] = e0 + u < E ? acc[e0 + u] : 0.f;
    const float s = earl::warp_sums32(v);
    if (e0 + lane < E) red[warp][e0 + lane] = s;
  }
  __syncthreads();
  const int k = p.k, entries = k * (D + 1) + 1;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int o = -1;  // e's place in the output layout, -1 for a slot past k
    if (e < KM * D) {
      if (e / D < k) o = e;
    } else if (e < KM * (D + 1)) {
      if (e - KM * D < k) o = k * D + e - KM * D;
    } else {
      o = entries - 1;
    }
    if (o < 0) continue;
    float total = 0.f;
    for (int w = 0; w < earl::kWarps; ++w) total += red[w][e];
    p.part[static_cast<int64_t>(blockIdx.x) * entries + o] = total;
  }
  finish(p, entries);
}

// ---------------------------------------------------------------------------
// shared-slot layout: any (k, d) whose slots fit
// ---------------------------------------------------------------------------
__global__ void assign_slots(AssignArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, d = p.d, k = p.k;
  const int entries = k * (d + 1) + 1;
  float* acc = smem;                      // (entries, T)
  float* c_s = acc + entries * T;         // (k, d)
  float* cc_s = c_s + k * d;              // (k)
  int* notes = reinterpret_cast<int*>(cc_s + k);  // (d, T): PoisonNote.key

  for (int e = threadIdx.x; e < entries * T; e += T) acc[e] = 0.f;
  for (int e = threadIdx.x; e < d * T; e += T) notes[e] = -1;
  for (int e = threadIdx.x; e < k * d; e += T) c_s[e] = p.cent[e];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += T) {
    cc_s[j] = earl::sq_norm(c_s + j * d, d);
  }
  __syncthreads();

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * p.cols;
  const int64_t c1 = min(c0 + p.cols, static_cast<int64_t>(p.n));
  float inertia = 0.f;
  bool noted = false;
  for (int64_t i = c0 + threadIdx.x; i < c1; i += T) {
    const float* xr = p.x + i * d;
    float best;
    const int j = earl::nearest(xr, c_s, cc_s, d, k, best);
    const float wv = p.w != nullptr ? p.w[i] : 1.f;
    for (int q = 0; q < d; ++q) {
      float* a = acc + (j * d + q) * T + threadIdx.x;
      *a = __fmaf_rn(wv, xr[q], *a);
      if (!isfinite(xr[q])) {
        earl::PoisonNote nf;
        nf.key = notes[q * T + threadIdx.x];
        nf.note(j);
        notes[q * T + threadIdx.x] = nf.key;
        noted = true;
      }
    }
    float* cnt = acc + (k * d + j) * T + threadIdx.x;
    *cnt = __fadd_rn(*cnt, wv);
    inertia = __fmaf_rn(wv, best, inertia);
  }
  acc[(entries - 1) * T + threadIdx.x] = inertia;
  if (noted) {  // another cluster's non-finite value: NaN
    for (int q = 0; q < d; ++q) {
      earl::PoisonNote nf;
      nf.key = notes[q * T + threadIdx.x];
      for (int j = 0; j < k; ++j) {
        if (nf.poisons(j)) acc[(j * d + q) * T + threadIdx.x] =
            earl::poison_nan();
      }
    }
  }
  __syncthreads();

  // Entry e is summed by warp e % warps: each lane adds threads lane,
  // lane + 32, ... in order, then the warp's fixed butterfly.
  const int warps = T >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < entries; e += warps) {
    float s = 0.f;
    for (int t = lane; t < T; t += 32) s += acc[e * T + t];
    s = earl::warp_sum(s);
    if (lane == 0) p.part[static_cast<int64_t>(blockIdx.x) * entries + e] = s;
  }
  finish(p, entries);
}

template <int D>
cudaError_t launch_regs(const AssignArgs& a, cudaStream_t s) {
  assign_regs<D, kRegClusters><<<a.ranges, earl::kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (n, d), w (n) or null (unit weights), cent (k, d); part (ranges,
// entries) scratch; ticket one u32, 0 between launches; out (entries) =
// [sums (k, d) | counts (k) | inertia].  The register layout takes
// d <= 4, k <= 8 at 256 threads and a column range of a multiple of 4
// points; otherwise `threads` is a warp multiple whose shared slots fit
// (ops.assign_geometry).
extern "C" int earl_kmeans_assign(int n, int d, int k, const void* x,
                                  const void* w, const void* cent, int cols,
                                  int ranges, int threads, void* part,
                                  void* ticket, void* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || d < 1 ||
      k < 1 || ranges < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AssignArgs a;
  a.n = n;
  a.d = d;
  a.k = k;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.cent = static_cast<const float*>(cent);
  a.cols = cols;
  a.ranges = ranges;
  a.part = static_cast<float*>(part);
  a.ticket = static_cast<unsigned*>(ticket);
  a.out = static_cast<float*>(out);
  a.vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) &
           15u) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kRegMaxDim && k <= kRegClusters) {
    if (threads != earl::kThreads || cols % kQuad != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (d) {
      case 1: return static_cast<int>(launch_regs<1>(a, s));
      case 2: return static_cast<int>(launch_regs<2>(a, s));
      case 3: return static_cast<int>(launch_regs<3>(a, s));
      default: return static_cast<int>(launch_regs<4>(a, s));
    }
  }
  const int entries = k * (d + 1) + 1;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(entries + d) * threads + k * d + k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_slots, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  assign_slots<<<ranges, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
