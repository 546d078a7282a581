// Thread-private accumulator slots in shared memory, indexed by a column's
// key: the GROUP BY moments (kernel 6, fused_grouped.cu) and the bootstrap
// over k-means (kernel 8, fused_kmeans.cu, whose key is the column's
// cluster).
//
// A column adds to the slots of its own key only, so a weight costs a few
// shared read-add-writes, whatever the number of keys, in place of one
// register FMA per key and accumulator.  Slot e of thread t lies at
// e·kThreads + t: a warp's 32 lanes read and write 32 banks, never a
// conflict, and no two threads share a slot, so no atomics are needed and
// each thread folds its columns in column order, as a register would.
//
// Skipping another key's column is bitwise the dense fold under the mask
// w·(key == g) (kernel 2 under valid · (key == g)): that fold adds w·0·x,
// which is +0 for a finite x and leaves an accumulator that starts at +0
// unchanged (it is never -0), but is NaN for x = ±inf or NaN.  So a
// thread notes, per value column, the keys of the non-finite values it
// skipped (PoisonNote) and turns every slot of another key NaN before the
// block sums: a NaN there poisons every key but its own, as in the dense
// fold, the masked run and the reference's scan.
#pragma once

#include <cuda_runtime.h>

#include "moments_tile.cuh"

namespace earl {

// What a poisoned slot holds: a quiet NaN.
__device__ __forceinline__ float poison_nan() {
  return __int_as_float(0x7fffffff);
}

// The keys of the non-finite values a thread saw in one value column:
// none (-1), exactly one key (>= 0), or two or more (-2).  A key that
// matches no slot (a column without a key) is noted as one that no slot
// has.
struct PoisonNote {
  int key = -1;
  __device__ __forceinline__ void note(int k) {
    key = (key == -1 || key == k) ? k : -2;
  }
  // True when a non-finite value of another key than `k` was seen.
  __device__ __forceinline__ bool poisons(int k) const {
    return key == -2 || (key >= 0 && key != k);
  }
  // True when a non-finite value was seen at all.
  __device__ __forceinline__ bool any() const { return key != -1; }
};

// Zeroes the `count` slots of the calling thread.
__device__ __forceinline__ void zero_slots(float* slots, int count) {
  for (int e = 0; e < count; ++e) slots[e * kThreads + threadIdx.x] = 0.f;
}

// One level of warp_sums32: lanes with bit O set keep the upper half of
// their 2·O slots and send the lower half to their partner (lane ^ O),
// which keeps that half; each kept slot adds the partner's value of it.
template <int O>
__device__ __forceinline__ void butterfly_level(float (&v)[32]) {
  const bool upper = (threadIdx.x & O) != 0;
#pragma unroll
  for (int u = 0; u < O; ++u) {
    const float keep = upper ? v[u + O] : v[u];
    const float send = upper ? v[u] : v[u + O];
    v[u] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The warp sums of 32 slots at once: lane i holds v[u], its value of slot
// u, and gets back the warp's sum of slot i, bitwise warp_sum's (every lane
// of warp_sum ends with the same value, as a + b == b + a).  Each level
// halves the slots a lane carries, so one shuffle carries one slot's
// partner value where warp_sum spends one a slot and level: 31 shuffles
// for 32 slots, not 160.  The levels are templates, so every index into v
// is a constant and v stays in registers.
__device__ __forceinline__ float warp_sums32(float (&v)[32]) {
  butterfly_level<16>(v);
  butterfly_level<8>(v);
  butterfly_level<4>(v);
  butterfly_level<2>(v);
  butterfly_level<1>(v);
  return v[0];
}

// Sums each of the `count` slots over the CTA in block_sum's order (the
// warp's fixed butterfly, then the warps in order from 0.f) and calls
// write(e, total) in one thread per slot.  The butterflies go 32 slots at
// a time (warp_sums32); lane i of warp w leaves its sum of slot e + i in
// its own entry of slot e, which only warp w has read.  Every thread of
// the CTA must call it.
template <typename Write>
__device__ __forceinline__ void reduce_slots(float* slots, int count,
                                             Write write) {
  float* mine = slots + threadIdx.x;
  for (int e = 0; e < count; e += 32) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      v[u] = e + u < count ? mine[(e + u) * kThreads] : 0.f;
    }
    mine[e * kThreads] = warp_sums32(v);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const float* warps = slots + (e & ~31) * kThreads + (e & 31);
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += warps[w * 32];
    write(e, total);
  }
}

}  // namespace earl
