// Standalone implicit-weight kernel: the (Bp, np) Poisson(1) matrix.
//
// Replaces repro/kernels/poisson_counts/kernel.py: poisson_counts_kernel
// (_pc_kernel), the bitwise probe of the RNG tile and the materialized
// fallback for statistics without a fused path.  ``t0`` is the first
// n-tile: a launch draws n-tiles [t0, t0 + np / bn) at their own
// (seed, b-tile, n-tile) keys, so a tiled scan (fused_poisson_tiled) draws
// a bounded chunk of the stream at a time.
//
// Bound: one threefry2x32 per weight (integer ALU; the count is in
// poisson_tile.cuh); the output write of 4 bytes per weight takes less
// time at the card's memory rate.  Design: one CTA per RNG tile, whose
// key thread 0 derives once; threads walk the tile's flat index so the
// stores of a warp are contiguous within a row.
#include "poisson_tile.cuh"

namespace {

__global__ void __launch_bounds__(256)
poisson_counts_kernel(int32_t seed, int np, int bb, int bn, int t0,
                      float* __restrict__ out) {
  __shared__ earl::TileKey key;
  const int k = blockIdx.x, i = blockIdx.y;
  if (threadIdx.x == 0) key = earl::tile_key(seed, i, t0 + k);
  __syncthreads();
  const earl::TileKey tk = key;
  for (int e = threadIdx.x; e < bb * bn; e += blockDim.x) {
    const int r = e / bn, c = e - r * bn;
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(e);
    earl::threefry2x32(tk.k0, tk.k1, x0, x1);
    out[static_cast<int64_t>(i * bb + r) * np + static_cast<int64_t>(k) * bn +
        c] = earl::poisson_from_bits(x0 ^ x1);
  }
}

}  // namespace

extern "C" int earl_poisson_counts(int32_t seed, int Bp, int np, int bb,
                                   int bn, int t0, void* out, void* stream) {
  dim3 grid(np / bn, Bp / bb);
  poisson_counts_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, np, bb, bn, t0, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
