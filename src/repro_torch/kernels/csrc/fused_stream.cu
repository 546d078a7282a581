// Moments pass over x with implicit Poisson(1) weights, x streamed into
// shared memory through a two-slot cp.async ring.
//
// Replaces the TPU kernel repro/kernels/weighted_stats/kernel.py:
// fused_poisson_moments_stream_kernel (_fpm_stream_kernel): the outputs of
// fused_poisson_moments_kernel (w_tot (B,), s1 and s2 (B, d)), with x and
// the mask left in HBM and each n-tile copied asynchronously while the
// previous one is hashed and contracted.  Its contract is bit-identical
// outputs, so this kernel is fused_pass.cu's moments instance with only the
// way x reaches the threads changed: the same grid (_pass.pass_geometry's
// column ranges, blocks of 8 rows of W, z chunks of kDimChunk columns),
// the same columns per thread in the same order, the same f32 FMAs, the
// warp butterfly, the warps in order, one partial per (row, range) and
// sum_partials over the ranges in order (double for w_tot).  Repeated runs,
// and this kernel against fused_pass's, are bitwise equal.
//
// The ring: while tile t is hashed from slot t & 1, every thread issues its
// share of tile t + 1's copies into the other slot (cp.async, committed as
// one group), then waits for its own copies of tile t (wait_group 1) and
// the CTA meets at a barrier.  A slot is refilled only after the barrier
// that ends the last pass over it.  The mask has its own two slots.
//   * d <= 4 (one z chunk): a tile's bn·d floats are contiguous.  Whole
//     16-byte chunks go by 16-byte copies, the few floats before the first
//     aligned address and after the last one by 4-byte copies; the slot is
//     shifted by the source's misalignment (0..3 floats) so that aligned
//     global chunks land aligned in shared memory.  Rows of 4 or 12 bytes
//     (d = 1, 3) need no alignment of their own, and the tensor is never
//     padded for it.
//   * d > 4: the z chunk's columns dz..dz+3 of each row, one 16-byte copy
//     a row when d is a multiple of 4 and x is 16-byte aligned, else one
//     4-byte copy a float.
// The wrapper pads x and the mask to whole RNG tiles, so no tile is
// ragged; n_valid and the mask zero the padded columns' weights.
//
// Bound: operations, the hash (73 int32 operations a weight, counted in
// poisson_tile.cuh); x is 1/B of the weight work, so streaming it changes
// the bytes in flight, not the bound.
#include <cstdint>
#include <cuda_runtime.h>

#include "moments_tile.cuh"
#include "poisson_tile.cuh"

namespace earl {

constexpr int kMaxTileCols = 512;  // widest RNG n-tile (weight_tile_blocks)
// One slot: a tile of one z chunk, plus room for the alignment shift.
constexpr int kSlotFloats = kMaxTileCols * kDimChunk + 4;
constexpr int kMaskSlotFloats = kMaxTileCols + 4;

struct StreamParams {
  int32_t seed;
  int32_t n_valid;
  int Bp, bb, bn, np;  // padded rows, RNG tile shape, padded columns
  int d;
  const float* x;      // (np, d)
  const float* mask;   // (np) exact 0/1, or nullptr
  int rows;            // rows of W per CTA (<= kMaxRows)
  int tiles_per_cta;
  int ranges;
  float* part_w;       // (Bp, ranges)
  float* part_s1;      // (Bp, ranges, d)
  float* part_s2;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Misalignment of a global address past 16 bytes, in floats (0..3).
__device__ __forceinline__ int float_shift(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// This thread's share of copying `count` contiguous floats from `src` to
// dst[shift ..], shift = float_shift(src).
__device__ __forceinline__ void issue_slab(float* dst, const float* src,
                                           int count) {
  const int shift = float_shift(src);
  const int head = min(count, (4 - shift) & 3);
  const int chunks = (count - head) >> 2;
  const int tail = head + 4 * chunks;
  for (int e = threadIdx.x; e < head; e += blockDim.x) {
    cp_async4(dst + shift + e, src + e);
  }
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    cp_async16(dst + shift + head + 4 * k, src + head + 4 * k);
  }
  for (int e = tail + threadIdx.x; e < count; e += blockDim.x) {
    cp_async4(dst + shift + e, src + e);
  }
}

// This thread's share of tile t's x (its z chunk) and mask into slot `s`.
__device__ __forceinline__ void issue_tile(const StreamParams& p, int t,
                                           int dz, bool strip16, float* xs,
                                           float* ms) {
  const int64_t j0 = static_cast<int64_t>(t) * p.bn;
  if (p.d <= kDimChunk) {
    issue_slab(xs, p.x + j0 * p.d, p.bn * p.d);
  } else if (strip16) {
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      cp_async16(xs + kDimChunk * c, p.x + (j0 + c) * p.d + dz);
    }
  } else {
    const int dc = min(kDimChunk, p.d - dz);
    for (int e = threadIdx.x; e < p.bn * dc; e += blockDim.x) {
      const int c = e / dc, q = e - c * dc;
      cp_async4(xs + kDimChunk * c + q, p.x + (j0 + c) * p.d + dz + q);
    }
  }
  if (p.mask != nullptr) issue_slab(ms, p.mask + j0, p.bn);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
stream_moments_kernel(StreamParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float xs[2][kSlotFloats];
  __shared__ __align__(16) float ms[2][kMaskSlotFloats];
  __shared__ float red[kWarps];
  TileKey* keys = reinterpret_cast<TileKey*>(smem_raw);

  const int range = blockIdx.x;
  const int r0 = blockIdx.y * p.rows;
  const int dz = blockIdx.z * kDimChunk;
  const bool lead = blockIdx.z == 0;
  const int nt = p.np / p.bn;
  const int t0 = range * p.tiles_per_cta;
  const int t1 = min(t0 + p.tiles_per_cta, nt);
  const int nrows = min(p.rows, p.Bp - r0);
  const bool slab = p.d <= kDimChunk;
  const bool strip16 = !slab && (p.d % 4 == 0) && float_shift(p.x) == 0;
  // Where x value (column c, chunk column q) sits in a slot, and the mask
  // value of column c: the shift is the same for every tile, as a tile
  // starts bn·d floats (a multiple of 4 unless there is one tile) after
  // the previous one.
  const int x_off = slab ? float_shift(p.x) : 0;
  const int x_stride = slab ? p.d : kDimChunk;
  const int m_off = p.mask != nullptr ? float_shift(p.mask) : 0;

  if (t0 < t1) issue_tile(p, t0, dz, strip16, xs[0], ms[0]);
  int tsel[kMaxRows], trow[kMaxRows];
  cta_tile_keys<kMaxRows>(p.seed, p.bb, r0, t0, t1, keys, tsel, trow);

  float acc_w[kMaxRows];
  float acc_s1[kMaxRows][kDimChunk];
  float acc_s2[kMaxRows][kDimChunk];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    acc_w[r] = 0.f;
#pragma unroll
    for (int q = 0; q < kDimChunk; ++q) acc_s1[r][q] = acc_s2[r][q] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int slot = (t - t0) & 1;
    if (t + 1 < t1) {
      issue_tile(p, t + 1, dz, strip16, xs[slot ^ 1], ms[slot ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, the first time, the keys) visible

    const TileKey* tk = keys + 2 * (t - t0);
    const float* xt = xs[slot] + x_off;
    const float* mt = ms[slot] + m_off;
    for (int c = threadIdx.x; c < p.bn; c += blockDim.x) {
      const int64_t j = static_cast<int64_t>(t) * p.bn + c;
      float w[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        // implicit_weight's order: the draw, 0 past n_valid, then times
        // the exact 0/1 mask
        w[r] = r < nrows
                   ? implicit_weight(tk[tsel[r]],
                                     static_cast<uint32_t>(trow[r] * p.bn + c),
                                     j, p.n_valid, nullptr)
                   : 0.f;
        if (r < nrows && p.mask != nullptr) w[r] = __fmul_rn(w[r], mt[c]);
      }
      float xv[kDimChunk], x2[kDimChunk];
#pragma unroll
      for (int q = 0; q < kDimChunk; ++q) {
        xv[q] = dz + q < p.d ? xt[c * x_stride + q] : 0.f;
        x2[q] = __fmul_rn(xv[q], xv[q]);
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        acc_w[r] = __fadd_rn(acc_w[r], w[r]);
#pragma unroll
        for (int q = 0; q < kDimChunk; ++q) {
          acc_s1[r][q] = __fmaf_rn(w[r], xv[q], acc_s1[r][q]);
          acc_s2[r][q] = __fmaf_rn(w[r], x2[q], acc_s2[r][q]);
        }
      }
    }
    __syncthreads();  // every thread is done with the slot refilled next
  }

  // fused_pass.cu's epilogue
  write_moment_partials(acc_w, acc_s1, acc_s2, nrows, r0, range, p.ranges,
                        dz, p.d, lead, red, p.part_w, p.part_s1, p.part_s2);
}

}  // namespace earl

// Launches the pass and the in-order sums of its partials; returns
// cudaGetLastError() after the launches.
extern "C" int earl_fused_stream(int32_t seed, int32_t n_valid, int Bp,
                                 int np, int bb, int bn, int d, const void* x,
                                 const void* mask, int rows,
                                 int tiles_per_cta, int ranges, void* part_w,
                                 void* part_s1, void* part_s2, void* w_tot,
                                 void* s1, void* s2, void* stream) {
  // A CTA's rows must span at most two RNG b-tiles (fused_pass.cu); a tile
  // must fit a slot and start a whole number of 16-byte chunks after the
  // previous one (the RNG clamp gives bn in {128, 512}, or one tile).
  if (rows < 1 || rows > earl::kMaxRows || bb < earl::kMaxRows || d < 1 ||
      bn < 1 || bn > earl::kMaxTileCols || (bn % 4 != 0 && np != bn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  earl::StreamParams p{};
  p.seed = seed;
  p.n_valid = n_valid;
  p.Bp = Bp; p.bb = bb; p.bn = bn; p.np = np; p.d = d;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.rows = rows; p.tiles_per_cta = tiles_per_cta; p.ranges = ranges;
  p.part_w = static_cast<float*>(part_w);
  p.part_s1 = static_cast<float*>(part_s1);
  p.part_s2 = static_cast<float*>(part_s2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(earl::TileKey) * 2 * tiles_per_cta;
  const int zdim = (d + earl::kDimChunk - 1) / earl::kDimChunk;
  dim3 grid(ranges, (Bp + rows - 1) / rows, zdim);
  earl::stream_moments_kernel<<<grid, earl::kThreads, smem, s>>>(p);
  earl::sum_fused_partials(p.part_w, p.part_s1, p.part_s2,
                           static_cast<float*>(w_tot),
                           static_cast<float*>(s1), static_cast<float*>(s2),
                           Bp, ranges, 1, d, s);
  return static_cast<int>(cudaGetLastError());
}
