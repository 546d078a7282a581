// One weighted Lloyd assignment pass: sums (k, d), counts (k), inertia ().
//
// Replaces repro/kernels/kmeans_assign/kernel.py: kmeans_assign_kernel
// (_ka_kernel, with _assign_tile).  The TPU kernel computes a (bn, k)
// distance tile on the MXU and contracts a one-hot against x·w; here each
// thread takes one point at a time, finds its cluster with the d² of
// kmeans_tile.cuh (bitwise the plain version's), and adds w·x, w and
// w·min-d² to that cluster's accumulators.  Neither the (n, k) distances
// nor the one-hot exist anywhere.
//
// Bound: bytes.  x and w are read once (4·(d+1) bytes a point); the
// assignment is k·(2d+3) f32 operations a point, below the card's
// 20 operations a byte for every k·d the path uses (k = 5, d = 2).
//
// Accumulators: k·(d+1) per thread in shared memory, laid out
// [entry][thread] so a warp's updates hit 32 banks; a thread touches d+1
// of them per point, at its cluster.  The inertia stays in a register.  No
// float atomics: a CTA folds a fixed column range (a function of the
// shapes, from ops.assign_geometry), threads walk it in a fixed stride,
// the CTA sums its threads in a fixed order into one partial per (range,
// entry), and sum_partials adds the ranges in order, in double.  Counts of
// whole weights are exact in f32 within a CTA and in double across CTAs,
// so they are the exact totals rounded once, as the plain version's.
#include <cstdint>
#include <cuda_runtime.h>

#include "kmeans_tile.cuh"
#include "moments_tile.cuh"

namespace {

__global__ void kmeans_assign_kernel(int n, int d, int k,
                                     const float* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ cent, int cols,
                                     float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int entries = k * (d + 1) + 1;
  float* acc = smem;                      // (entries, T)
  float* c_s = acc + entries * T;         // (k, d)
  float* cc_s = c_s + k * d;              // (k)

  for (int e = threadIdx.x; e < entries * T; e += T) acc[e] = 0.f;
  for (int e = threadIdx.x; e < k * d; e += T) c_s[e] = cent[e];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += T) {
    cc_s[j] = earl::sq_norm(c_s + j * d, d);
  }
  __syncthreads();

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int64_t c1 = min(c0 + cols, static_cast<int64_t>(n));
  float inertia = 0.f;
  for (int64_t i = c0 + threadIdx.x; i < c1; i += T) {
    const float* xr = x + i * d;
    float best;
    const int j = earl::nearest(xr, c_s, cc_s, d, k, best);
    const float wv = w[i];
    for (int q = 0; q < d; ++q) {
      float* a = acc + (j * d + q) * T + threadIdx.x;
      *a = __fmaf_rn(wv, xr[q], *a);
    }
    float* cnt = acc + (k * d + j) * T + threadIdx.x;
    *cnt = __fadd_rn(*cnt, wv);
    inertia = __fmaf_rn(wv, best, inertia);
  }
  acc[(entries - 1) * T + threadIdx.x] = inertia;
  __syncthreads();

  // Entry e is summed by warp e % warps: each lane adds threads lane,
  // lane + 32, ... in order, then the warp's fixed butterfly.
  const int warps = T >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < entries; e += warps) {
    float s = 0.f;
    for (int t = lane; t < T; t += 32) s += acc[e * T + t];
    s = earl::warp_sum(s);
    if (lane == 0) part[static_cast<int64_t>(blockIdx.x) * entries + e] = s;
  }
}

}  // namespace

// x (n, d), w (n), cent (k, d); part (ranges, entries) scratch; out
// (entries) = [sums (k, d) | counts (k) | inertia].  `threads` is a warp
// multiple whose accumulators fit in shared memory (ops.assign_geometry).
extern "C" int earl_kmeans_assign(int n, int d, int k, const void* x,
                                  const void* w, const void* cent, int cols,
                                  int ranges, int threads, void* part,
                                  void* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || d < 1 ||
      k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int entries = k * (d + 1) + 1;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(entries) * threads + k * d + k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  kmeans_assign_kernel<<<ranges, threads, smem, s>>>(
      n, d, k, static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(cent), cols, p);
  const int t = 256;
  earl::sum_partials<double><<<(entries + t - 1) / t, t, 0, s>>>(
      p, static_cast<float*>(out), 1, ranges, entries);
  return static_cast<int>(cudaGetLastError());
}
