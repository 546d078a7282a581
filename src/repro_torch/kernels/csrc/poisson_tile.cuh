// The implicit Poisson(1) weight tile, shared by every kernel of the port.
//
// Replaces the per-tile draw of the TPU kernels
// (repro/kernels/poisson_counts/kernel.py: _threefry_bits, _poisson_from_bits;
// repro/kernels/weighted_stats/kernel.py: _poisson_tile), on its threefry
// path (the TPU hardware PRNG branch has no bitwise counterpart).
//
// Tile (i, k) of shape (bb, bn) draws from
//   key = fold_in(fold_in(PRNGKey(seed), i), k)
// and element (r, c) of the tile hashes the counter pair (0, r*bn + c)
// (jax's partitionable threefry over the flat index within the tile) and
// keeps bits1 ^ bits2.  Every weight is a pure function of (seed, tile,
// flat index), so a CTA may cover any sub-block of any tile.
//
// The weight is the number of Poisson(1) CDF rungs strictly below
// u = (bits >> 8) * 2^-24.  The rungs come from the generated header
// poisson_cdf.h, written at build time from the same f32 values the plain
// PyTorch version uses (repro_torch/kernels/poisson_counts/ref.py).
//
// Cost: two threefry2x32 per tile for the key, one per weight.  The one
// count of the port's integer bound (chip_smoke.py OPS_PER_WEIGHT and
// PERF.md use it) is 73 32-bit integer operations per weight:
//   60  the 20 rounds, each an add, a rotate (one funnel shift) and a xor;
//   12  the 6 key injections, two adds each (k + i is fixed per tile);
//    1  the final bits1 ^ bits2.
// The f32 ladder, the n_valid compare and the mask multiply come on top
// and are not counted, so the bound is a little low.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "poisson_cdf.h"

namespace earl {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define EARL_TF_ROUND(r) \
  x0 += x1;              \
  x1 = rotl32(x1, r) ^ x0;

// Threefry-2x32, 20 rounds: the schedule of jax._src.prng's unrolled
// lowering.  (x0, x1) is the counter pair in, the hash out.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  EARL_TF_ROUND(13) EARL_TF_ROUND(15) EARL_TF_ROUND(26) EARL_TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  EARL_TF_ROUND(17) EARL_TF_ROUND(29) EARL_TF_ROUND(16) EARL_TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  EARL_TF_ROUND(13) EARL_TF_ROUND(15) EARL_TF_ROUND(26) EARL_TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  EARL_TF_ROUND(17) EARL_TF_ROUND(29) EARL_TF_ROUND(16) EARL_TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  EARL_TF_ROUND(13) EARL_TF_ROUND(15) EARL_TF_ROUND(26) EARL_TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef EARL_TF_ROUND

struct TileKey {
  uint32_t k0, k1;
};

// fold_in(fold_in(PRNGKey(seed), i), k); PRNGKey of an int32 seed is
// (0, seed) and fold_in(key, v) hashes the counter pair (0, v).
__device__ __forceinline__ TileKey tile_key(int32_t seed, uint32_t i,
                                            uint32_t k) {
  uint32_t a = 0u, b = i;
  threefry2x32(0u, static_cast<uint32_t>(seed), a, b);
  uint32_t c = 0u, d = k;
  threefry2x32(a, b, c, d);
  return TileKey{c, d};
}

__device__ __forceinline__ float poisson_from_bits(uint32_t bits) {
  // (bits >> 8) has 24 bits, so the conversion and the scale are exact.
  const float u = __fmul_rn(__uint2float_rn(bits >> 8), 0x1p-24f);
  float count = 0.f;
  count += (u > EARL_POISSON_CDF_0) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_1) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_2) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_3) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_4) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_5) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_6) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_7) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_8) ? 1.f : 0.f;
  count += (u > EARL_POISSON_CDF_9) ? 1.f : 0.f;
  return count;
}

// The keys of every RNG tile a CTA touches, into shared memory: n-tiles
// [t0, t1) of the (at most two) b-tiles that its rows r0.. span, two keys
// an n-tile; and each of its R rows' b-tile (0 or 1 past r0 / bb) and row
// within that tile.  The caller synchronizes before reading the keys.
template <int R>
__device__ __forceinline__ void cta_tile_keys(int32_t seed, int bb, int r0,
                                              int t0, int t1, TileKey* keys,
                                              int* tsel, int* trow) {
  const int i_first = r0 / bb;
  for (int q = threadIdx.x; q < 2 * (t1 - t0); q += blockDim.x) {
    keys[q] = tile_key(seed, static_cast<uint32_t>(i_first + (q & 1)),
                       static_cast<uint32_t>(t0 + (q >> 1)));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = r0 + r;
    tsel[r] = b / bb - i_first;
    trow[r] = b - (b / bb) * bb;
  }
}

// Poisson(1) weight of element `ctr` (flat index within its tile) of the
// tile keyed by `key`, at global column `col`: 0 past n_valid, then times
// the exact 0/1 mask when there is one (the order of the TPU kernels).
__device__ __forceinline__ float implicit_weight(TileKey key, uint32_t ctr,
                                                 int64_t col, int32_t n_valid,
                                                 const float* mask) {
  uint32_t x0 = 0u, x1 = ctr;
  threefry2x32(key.k0, key.k1, x0, x1);
  float w = poisson_from_bits(x0 ^ x1);
  if (col >= n_valid) w = 0.f;
  if (mask != nullptr) w = __fmul_rn(w, mask[col]);
  return w;
}

}  // namespace earl
