// A point's nearest centroid, with d² in the plain version's fixed order.
//
// Replaces the assignment of repro/kernels/kmeans_assign/kernel.py:
// _assign_tile, whose x·c is an MXU dot.  Here every product and sum is
// its own IEEE f32 operation (no FMA contraction), in the order of
// repro_torch/kernels/kmeans_assign/ops.py: assign_tile:
//   xx = Σ_q x_q·x_q,  xc = Σ_q x_q·c_q  (ascending q),
//   d² = max((xx − 2·xc) + cc, 0),
// so d² and the argmin (ties to the lowest index; a NaN d², from a value
// that is not finite, wins over any number, the first NaN over later ones,
// as argmin and min do in the plain version and in the reference) are
// bitwise the plain version's.
#pragma once

#include <cuda_runtime.h>

namespace earl {

__device__ __forceinline__ float sq_norm(const float* v, int d) {
  float s = __fmul_rn(v[0], v[0]);
  for (int q = 1; q < d; ++q) s = __fadd_rn(s, __fmul_rn(v[q], v[q]));
  return s;
}

// Index of the centroid nearest `xr` among the k rows of `c` (d wide),
// with their squared norms `cc`; its d² goes to `best`.
__device__ __forceinline__ int nearest(const float* xr, const float* c,
                                       const float* cc, int d, int k,
                                       float& best) {
  const float xx = sq_norm(xr, d);
  int jstar = 0;
  best = 0.f;
  for (int j = 0; j < k; ++j) {
    const float* cj = c + j * d;
    float xc = __fmul_rn(xr[0], cj[0]);
    for (int q = 1; q < d; ++q) xc = __fadd_rn(xc, __fmul_rn(xr[q], cj[q]));
    float d2 = __fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, xc)), cc[j]);
    d2 = d2 < 0.f ? 0.f : d2;
    if (j == 0 || d2 < best || (isnan(d2) && !isnan(best))) {
      best = d2;
      jstar = j;
    }
  }
  return jstar;
}

}  // namespace earl
