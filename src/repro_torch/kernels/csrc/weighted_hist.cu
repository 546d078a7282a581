// Weighted histogram sketch of explicit weights: x (n, d) under R rows of
// weights W (R, n) gives counts (R, d, nbins); a null W is one row of unit
// weights (a point estimate).  Values are binned by bin_index
// (hist_tile.cuh): out-of-range values and +-inf clip to the edge bins,
// NaN carries no mass.
//
// Replaces the TPU kernel repro/kernels/weighted_hist/kernel.py:
// weighted_hist_kernel (_wh_kernel), which builds a (bn, bd, nbins) one-hot
// in VMEM and contracts it with the (bn, 1) weights.  Here each nonzero
// weight lands in its bin with one shared-memory atomic add.
//
// Bound: reading W, R·n·4 bytes (0.32 ms at R = 256, n = 2^20 + 37), or at
// R = 1 without W reading x (0.02 ms at n = 2^24 − 1000).
//
// With W (weighted_hist_kernel): a CTA of 512 threads, two an SM, takes
// up to 4 rows of W, a range of 4-column groups and a chunk of `dc`
// dimensions, and keeps rows·dc·nbins bins in shared memory, added into
// the zeroed output once at the end.  A whole-number weight in [0, 255]
// is added to a u32 bin (Hopper's u32 shared atomics run about 6.6x faster
// than f32 ones, which it emulates with a compare-and-swap loop), any
// other weight to an f32 bin beside it; where two sets of bins do not fit,
// every weight goes to the f32 bins.  W is streamed with 16-byte loads, a
// 4-column group of each of its rows a thread, 64 registers a thread, so
// 32 warps an SM keep the loads in flight, and no barrier stops the loop
// (measured faster than 8 rows at one CTA an SM with the next group's
// loads issued early into a second set of registers).  Rows of W start
// r·n floats apart, so a row's 16-byte groups start `head` (0..3) columns
// in: the head and the tail (the columns past the last whole group) are
// read one float at a time, by the first and the last range.  A thread
// bins the 7 values its group of each row can reach (columns 4g .. 4g+6)
// once for all the CTA's rows, into its own slot of shared memory.  Past
// one row's d·nbins bins in an SM's shared memory the wrapper cuts the
// dimensions into chunks (grid z), each reading W again.
//
// Unit weights (unit_hist_kernel): every value of the flat (n·d) x adds 1,
// so every thread of a CTA adds into the same d·nbins bins.  Each warp
// adds into one of `copies` private u32 copies of them (4, two warps a
// copy, as the wrapper chooses), after adding equal bins of its own 4
// values together; the copies are summed at the flush.  x is streamed
// with 16-byte loads, 4 a thread in flight, around a scalar head and tail.
//
// Counts of whole-number weights are exact in f32 below 2^24 a bin, in any
// order of the atomics, so they are bitwise the plain version's and repeat
// bitwise; sums of fractional weights round in the atomics' order, which
// changes from run to run.  ops.py: hist_geometry and aligned_split mirror
// the geometry.
//
// Grid: x = ranges of `groups` 4-column groups, y = blocks of `rows` rows
// (1 without W), z = chunks of `dc` dimensions.
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"
#include "moments_tile.cuh"

namespace earl {

constexpr int kHistThreads = 512;  // threads of a CTA with W, 2 an SM
constexpr int kHistRows = 4;       // rows of W a CTA at most
constexpr int kSpan = 7;           // columns 4g .. 4g+6 a group may need
constexpr int kSlot = 9;           // a thread's shared bin slot (odd: no
                                   // bank conflicts), kSpan used
constexpr uint32_t kNoBin = 0xffffffffu;  // NaN, or past n: no mass
constexpr int kMaxCopies = kWarps;        // private histograms, unit weights

struct HistParams {
  int R, n, d, nbins;
  int dc;           // dimensions a CTA
  const float* x;   // (n, d)
  const float* w;   // (R, n), or nullptr: one row of unit weights
  const float* lo;  // (d)
  const float* hi;  // (d)
  int rows;         // rows of W a CTA
  int groups;       // 4-column groups a range
  int ranges;
  int copies;       // private histograms (unit weights)
  bool whole_bins;  // u32 bins for whole-number weights beside the f32 ones
  float* out;       // (R, d * nbins), zeroed
};

// Floats past a 16-byte boundary of element `offset` of `base`.
__device__ __forceinline__ int phase_of(const float* base, int64_t offset) {
  return static_cast<int>(((reinterpret_cast<uintptr_t>(base) >> 2) +
                           static_cast<uint64_t>(offset)) & 3u);
}

// A row of `len` floats that starts `phase` floats past a 16-byte boundary:
// `head` scalar columns, then `groups` whole 16-byte groups, then the tail.
__device__ __forceinline__ void aligned_split(int64_t len, int phase,
                                              int& head, int64_t& groups) {
  head = static_cast<int>(min(static_cast<int64_t>((4 - phase) & 3), len));
  groups = (len - head) >> 2;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Adds weight `wv` at bin `b` of a row: a whole number in [0, 255] into
// the u32 bins (when `whole`: there are), anything else into the f32 bins.
__device__ __forceinline__ void add_weight(uint32_t* ubins, float* fbins,
                                           bool whole, int b, float wv) {
  if (whole && wv >= 0.f && wv <= 255.f && wv == truncf(wv)) {
    atomicAdd(ubins + b, static_cast<uint32_t>(wv));
  } else {
    atomicAdd(fbins + b, wv);
  }
}

__global__ void __launch_bounds__(kHistThreads, 2)
weighted_hist_kernel(HistParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int total = p.d * p.nbins;
  const int d0 = blockIdx.z * p.dc;
  const int dn = min(p.dc, p.d - d0);
  const int len = dn * p.nbins;  // the CTA's bins a row
  const int cap = p.rows * p.dc * p.nbins;  // bins a set holds
  float* fbins = reinterpret_cast<float*>(smem_raw);
  // shared-memory pointers the compiler can see, so the atomics are ATOMS
  uint32_t* ubins = reinterpret_cast<uint32_t*>(fbins + cap);
  const bool whole = p.whole_bins;
  uint32_t* slot =
      reinterpret_cast<uint32_t*>(fbins + (whole ? 2 : 1) *
                                              static_cast<size_t>(cap)) +
      threadIdx.x * kSlot;
  const int r0 = blockIdx.y * p.rows;
  const int nrows = min(p.rows, p.R - r0);
  const int range = blockIdx.x;
  // each row's head (0..3 columns), 2 bits a row: rows of W start r·n
  // floats apart; a row then has (n - head) / 4 whole groups
  uint32_t heads = 0u;
#pragma unroll
  for (int r = 0; r < kHistRows; ++r) {
    int h;
    int64_t g;
    aligned_split(p.n, phase_of(p.w, static_cast<int64_t>(r0 + r) * p.n), h,
                  g);
    heads |= static_cast<uint32_t>(h) << (2 * r);
  }
  auto head_of = [&](int r) {
    return static_cast<int>((heads >> (2 * r)) & 3u);
  };
  const int64_t m_lo = static_cast<int64_t>(range) * p.groups;
  const int64_t m_hi = min(m_lo + p.groups, static_cast<int64_t>(p.n) / 4);

  for (int e = threadIdx.x; e < nrows * len; e += blockDim.x) {
    fbins[e] = 0.f;
    if (whole) ubins[e] = 0u;
  }
  __syncthreads();

  // the head (first range) and the tail (last range), a float at a time
  for (int e = threadIdx.x; e < nrows * 8; e += blockDim.x) {
    const int r = e >> 3;
    const int c = e & 7;
    const int h = head_of(r);
    int64_t j = -1;
    if (c < 4 && range == 0 && c < h) j = c;
    if (c >= 4 && range == p.ranges - 1) {
      const int64_t t = h + 4 * ((p.n - h) >> 2) + (c - 4);
      if (t < p.n) j = t;
    }
    if (j < 0) continue;
    const float wv = __ldg(p.w + static_cast<int64_t>(r0 + r) * p.n + j);
    if (wv == 0.f) continue;
    for (int k = 0; k < dn; ++k) {
      const int dd = d0 + k;
      const float xv = __ldg(p.x + j * p.d + dd);
      if (isnan(xv)) continue;  // NaN carries no mass
      const int b = r * len + k * p.nbins +
                    bin_index(xv, __ldg(p.lo + dd), __ldg(p.hi + dd), p.nbins);
      add_weight(ubins, fbins, whole, b, wv);
    }
  }

  // W's 16-byte groups m_lo + thread + 512·i of each row.  No barrier: a
  // thread bins the values its group needs into its own shared slot.
  for (int64_t g = m_lo + threadIdx.x; g < m_hi; g += kHistThreads) {
    float4 v[kHistRows];
#pragma unroll
    for (int r = 0; r < kHistRows; ++r) {
      v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int h = head_of(r);
      if (r < nrows && g < ((p.n - h) >> 2)) {
        v[r] = __ldcs(reinterpret_cast<const float4*>(
            p.w + static_cast<int64_t>(r0 + r) * p.n + h + 4 * g));
      }
    }
    for (int k = 0; k < dn; ++k) {
      const int dd = d0 + k;
      const float lo = __ldg(p.lo + dd), hi = __ldg(p.hi + dd);
      // bins of columns 4g .. 4g+6: a row's group starts 0..3 columns in
#pragma unroll
      for (int i = 0; i < kSpan; ++i) {
        const int64_t j = 4 * g + i;
        uint32_t b = kNoBin;
        if (j < p.n) {
          const float xv = __ldg(p.x + j * p.d + dd);
          if (!isnan(xv)) b = k * p.nbins + bin_index(xv, lo, hi, p.nbins);
        }
        slot[i] = b;
      }
#pragma unroll
      for (int r = 0; r < kHistRows; ++r) {
        const int h = head_of(r);
        // the row's 4 weights as u32, when all are whole numbers in
        // [0, 255] (Poisson counts are): one test for the group
        uint32_t wi[4];
        bool group_whole = whole;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wv = lane(v[r], c);
          wi[c] = __float2uint_rz(wv);
          group_whole = group_whole && wv >= 0.f && wi[c] <= 255u &&
                        __uint2float_rz(wi[c]) == wv;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wv = lane(v[r], c);
          const uint32_t b = slot[h + c];
          if (wv == 0.f || b == kNoBin) continue;
          const int at = r * len + static_cast<int>(b);
          if (group_whole) {
            atomicAdd(ubins + at, wi[c]);
          } else {
            add_weight(ubins, fbins, whole, at, wv);
          }
        }
      }
    }
  }
  __syncthreads();
  // whole counts below 2^24 convert to f32 exactly
  for (int e = threadIdx.x; e < nrows * len; e += blockDim.x) {
    float v = fbins[e];
    if (whole) v = static_cast<float>(ubins[e]) + v;
    if (v != 0.f) {
      const int r = e / len;
      atomicAdd(p.out + static_cast<int64_t>(r0 + r) * total + d0 * p.nbins +
                    (e - r * len),
                v);
    }
  }
}

// Adds 1 for each of a thread's 4 bins (-1: none) into its warp's copy,
// equal bins together.
__device__ __forceinline__ void add_units(uint32_t* copy, int (&b)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (b[c] < 0) continue;
    uint32_t cnt = 1u;
#pragma unroll
    for (int o = c + 1; o < 4; ++o) {
      if (b[o] == b[c]) {
        ++cnt;
        b[o] = -1;
      }
    }
    atomicAdd(copy + b[c], cnt);
  }
}

__global__ void __launch_bounds__(kThreads)
unit_hist_kernel(HistParams p) {
  extern __shared__ __align__(16) uint32_t sub[];
  const int d0 = blockIdx.z * p.dc;
  const int dn = min(p.dc, p.d - d0);
  const int len = dn * p.nbins;
  for (int e = threadIdx.x; e < p.copies * len; e += blockDim.x) sub[e] = 0u;
  __syncthreads();
  uint32_t* copy = sub + ((threadIdx.x >> 5) % p.copies) * len;

  // x flat: element e is value (e / d, e % d)
  const int64_t L = static_cast<int64_t>(p.n) * p.d;
  int head;
  int64_t groups;
  aligned_split(L, phase_of(p.x, 0), head, groups);
  const int range = blockIdx.x;
  const int64_t m_lo = static_cast<int64_t>(range) * p.groups;
  const int64_t m_hi = min(m_lo + p.groups, groups);
  // bin of flat element e (-1: another chunk's dimension, or NaN)
  auto bin_of = [&](int64_t e, float xv) -> int {
    const int dd = p.d == 1 ? 0 : static_cast<int>(e % p.d);
    const int k = dd - d0;
    if (k < 0 || k >= dn || isnan(xv)) return -1;
    return k * p.nbins +
           bin_index(xv, __ldg(p.lo + dd), __ldg(p.hi + dd), p.nbins);
  };

  // the head (first range) and the tail (last range), a float at a time
  if (threadIdx.x < 8) {
    const int c = threadIdx.x;
    int64_t e = -1;
    if (c < 4 && range == 0 && c < head) e = c;
    if (c >= 4 && range == p.ranges - 1 && head + 4 * groups + (c - 4) < L) {
      e = head + 4 * groups + (c - 4);
    }
    if (e >= 0) {
      const int b = bin_of(e, __ldg(p.x + e));
      if (b >= 0) atomicAdd(copy + b, 1u);
    }
  }

  const float4* x4 = reinterpret_cast<const float4*>(p.x + head);
  for (int64_t g = m_lo + threadIdx.x; g < m_hi; g += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t gu = g + u * kThreads;
      if (gu < m_hi) v[u] = __ldcs(x4 + gu);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t gu = g + u * kThreads;
      if (gu >= m_hi) continue;
      const int64_t e0 = head + 4 * gu;
      int b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = bin_of(e0 + c, lane(v[u], c));
      add_units(copy, b);
    }
  }
  __syncthreads();
  // sum the copies; counts below 2^24 convert to f32 exactly
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    uint32_t s = 0u;
    for (int c = 0; c < p.copies; ++c) s += sub[c * len + e];
    if (s != 0u) atomicAdd(p.out + d0 * p.nbins + e, static_cast<float>(s));
  }
}

}  // namespace earl

// Returns cudaGetLastError() after the launch.
extern "C" int earl_weighted_hist(int R, int n, int d, int nbins,
                                  const void* x, const void* w,
                                  const void* lo, const void* hi, int dc,
                                  int rows, int groups, int ranges,
                                  int copies, int whole_bins, void* out,
                                  void* stream) {
  if (rows < 1 || rows > earl::kHistRows || groups < 1 || ranges < 1 ||
      dc < 1 || dc > d || nbins < 1 ||
      copies < 1 || copies > earl::kMaxCopies ||
      (w == nullptr && (R != 1 || rows != 1)) ||
      (reinterpret_cast<uintptr_t>(x) & 3u) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 3u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::HistParams p{};
  p.R = R; p.n = n; p.d = d; p.nbins = nbins; p.dc = dc;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.lo = static_cast<const float*>(lo);
  p.hi = static_cast<const float*>(hi);
  p.rows = rows; p.groups = groups; p.ranges = ranges; p.copies = copies;
  p.whole_bins = whole_bins != 0;
  p.out = static_cast<float*>(out);
  const dim3 grid(ranges, (R + rows - 1) / rows, (d + dc - 1) / dc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == nullptr) {
    const size_t smem = sizeof(uint32_t) * static_cast<size_t>(copies) * dc *
                        nbins;
    cudaError_t e = cudaFuncSetAttribute(
        earl::unit_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    earl::unit_hist_kernel<<<grid, earl::kThreads, smem, s>>>(p);
  } else {
    const size_t smem =
        sizeof(float) * (whole_bins ? 2 : 1) * static_cast<size_t>(rows) *
            dc * nbins +
        sizeof(uint32_t) * earl::kHistThreads * earl::kSlot;
    cudaError_t e = cudaFuncSetAttribute(
        earl::weighted_hist_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    earl::weighted_hist_kernel<<<grid, earl::kHistThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
