// Kernel 12's backward: the gradient of blockwise (flash) attention with
// causal and sliding-window masks, GQA and a query offset.
//
// No TPU kernel stands behind it: the JAX package trains through its
// "blockwise" path (repro/kernels/flash_attention/ops.py: _blockwise),
// which XLA differentiates.  The port trains through kernel 12
// (flash_attention.cu), so this kernel is its derivative, and
// kernels/flash_attention/ops.py: flash_attention_backward_plain is its
// plain version.
//
// Inputs: q, o and dO (B·Hq, Sq, D), k and v (B·Hkv, Skv, D), f32 or bf16,
// and the forward's per-row log-sum-exp lse (B·Hq, Sq) f32; outputs dq,
// dk and dv in the inputs' dtype, accumulated in IEEE f32 (no TF32, no
// fast math).  Masks as the forward's: key c is visible to query row r
// (absolute position r + kv_offset) when c < Skv, r < Sq, c <= r +
// kv_offset (causal) and c > r + kv_offset - window (a window > 0).  The
// KV head of query head h of batch b is b·Hkv + h / (Hq / Hkv).  Three
// launches:
//
//   (a) Δ = rowsum(dO ∘ O) in f32, a warp a row;
//   (b) dK and dV: a CTA per (b·hkv, block of KB keys).  It walks the
//       group's Hq / Hkv query heads and, for each, the query tiles that
//       can see its keys, in a fixed order; for each (row, key) pair it
//       recomputes P = exp(scale·q·kᵀ − lse) (0 where masked) and dP =
//       dO·vᵀ, and accumulates dV += P·dO and dK += P·(dP − Δ)·q, scaled
//       by `scale` at the end;
//   (c) dQ: a CTA per (b·hq, block of RQ rows).  It walks the key tiles
//       its rows can see and accumulates dQ += P·(dP − Δ)·k, scaled at the
//       end.
//
// Fixed order, no atomics: two launches give the same bits.  A row that
// sees no key has lse = -inf and P = 0 everywhere: zero gradients.
//
// Bound: five products of 2·D operations a visible pair (S, dP, dV, dK,
// dQ), 10·D; the bytes (q, k, v, o, dO, lse once, dq, dk, dv once) take
// far less time.  This first design runs on the CUDA cores in f32 FMAs,
// as kernel 12's first design did: (b) and (c) each recompute S and dP,
// so the card does 14·D operations a pair.  Each thread owns one key (b)
// or one query row (c) and DH of its D columns (TPR threads a key or row,
// neighbouring lanes, their partial dot products summed by shuffles); the
// operand it walks over (q and dO tiles in (b), k and v tiles in (c))
// sits in shared memory, each row's parts DH + 4 floats apart so that the
// float4 reads of a row's parts fall on different banks.  Threads a CTA
// stay at or under 256 (launch bounds of one CTA an SM), so a thread may
// hold 4·DH (b) or 3·DH (c) f32 registers of its row without spilling.  A
// wgmma/TMA design is later work (ROADMAP.md §2).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // RNE
}

__device__ __forceinline__ bool visible(int col, int pos, int Skv,
                                        int causal, int window) {
  return col < Skv && (!causal || col <= pos) &&
         (window <= 0 || col > pos - window);
}

// (a) Δ: eight rows a CTA of 256 threads, a warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO,
                    float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const T* orow = o + row * D;
  const T* drow = dO + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(load(orow + d), load(drow + d), s);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) delta[row] = s;
}

// Loads rows [r0, r0 + R) of a (S, D) matrix into a shared tile laid out
// [R][TPR][DH + 4], zeros past S and past D.
template <typename T, int R, int DH, int TPR, int THREADS>
__device__ __forceinline__ void load_tile(float (*tile)[TPR][DH + 4],
                                          const T* __restrict__ src, int r0,
                                          int S, int D) {
  for (int e = threadIdx.x; e < R * TPR * DH; e += THREADS) {
    const int i = e / (TPR * DH), dd = e - i * (TPR * DH);
    const int r = r0 + i;
    const bool ok = r < S && dd < D;
    tile[i][dd / DH][dd % DH] =
        ok ? load(src + static_cast<int64_t>(r) * D + dd) : 0.f;
  }
}

// (b) dK and dV.  KB keys a CTA, TPR threads a key; BQ query rows a tile.
template <typename T, int DH, int TPR, int KB, int BQ>
__global__ void __launch_bounds__(TPR * KB, 1)
attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int BHkv, int Hq, int Hkv, int Sq,
                   int Skv, int D, float scale, int causal, int window,
                   int kv_offset) {
  constexpr int kThreads = TPR * KB;
  __shared__ __align__(16) float qs[BQ][TPR][DH + 4];
  __shared__ __align__(16) float dos[BQ][TPR][DH + 4];
  __shared__ float ls[BQ], dl[BQ];

  const int bh = blockIdx.x % BHkv;  // b·Hkv + kv head
  const int kb = blockIdx.x / BHkv;
  const int b = bh / Hkv, hkv = bh % Hkv;
  const int G = Hq / Hkv;
  const int part = threadIdx.x % TPR;
  const int key = kb * KB + threadIdx.x / TPR;
  const bool key_ok = key < Skv;
  const int d0 = part * DH;

  float kr[DH], vr[DH], dka[DH], dva[DH];
  {
    const int64_t base = (static_cast<int64_t>(bh) * Skv + (key_ok ? key : 0)) * D;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const bool ok = key_ok && d0 + d < D;
      kr[d] = ok ? load(k + base + d0 + d) : 0.f;
      vr[d] = ok ? load(v + base + d0 + d) : 0.f;
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
  }

  // the query rows some key of this block is visible to: causal, a row
  // at or past the first key; windowed, before the last key + window
  const int key_first = kb * KB;
  const int key_last = min(key_first + KB, Skv) - 1;
  const int r_beg = causal ? max(0, key_first - kv_offset) : 0;
  const int r_end =
      window > 0 ? min(Sq, key_last + window - kv_offset) : Sq;  // exclusive

  for (int g = 0; g < G; ++g) {
    const int bhq = b * Hq + hkv * G + g;
    const T* qb = q + static_cast<int64_t>(bhq) * Sq * D;
    const T* db = dO + static_cast<int64_t>(bhq) * Sq * D;
    const float* lb = lse + static_cast<int64_t>(bhq) * Sq;
    const float* deb = delta + static_cast<int64_t>(bhq) * Sq;
    for (int t0 = (r_beg / BQ) * BQ; t0 < r_end; t0 += BQ) {
      __syncthreads();  // every thread is done with the previous tile
      load_tile<T, BQ, DH, TPR, kThreads>(qs, qb, t0, Sq, D);
      load_tile<T, BQ, DH, TPR, kThreads>(dos, db, t0, Sq, D);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool ok = t0 + i < Sq;
        ls[i] = ok ? lb[t0 + i] : 0.f;
        dl[i] = ok ? deb[t0 + i] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float4* q4 = reinterpret_cast<const float4*>(&qs[i][part][0]);
        const float4* d4 = reinterpret_cast<const float4*>(&dos[i][part][0]);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 qq = q4[c], dd = d4[c];
          s = fmaf(qq.x, kr[4 * c], s);
          s = fmaf(qq.y, kr[4 * c + 1], s);
          s = fmaf(qq.z, kr[4 * c + 2], s);
          s = fmaf(qq.w, kr[4 * c + 3], s);
          dp = fmaf(dd.x, vr[4 * c], dp);
          dp = fmaf(dd.y, vr[4 * c + 1], dp);
          dp = fmaf(dd.z, vr[4 * c + 2], dp);
          dp = fmaf(dd.w, vr[4 * c + 3], dp);
        }
#pragma unroll
        for (int m = 1; m < TPR; m <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, m);
          dp += __shfl_xor_sync(0xffffffffu, dp, m);
        }
        const int row = t0 + i;
        const bool ok = key_ok && row < Sq &&
                        visible(key, row + kv_offset, Skv, causal, window);
        const float p = ok ? expf(s * scale - ls[i]) : 0.f;
        const float ds = p * (dp - dl[i]);
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 qq = q4[c], dd = d4[c];
          dva[4 * c] = fmaf(p, dd.x, dva[4 * c]);
          dva[4 * c + 1] = fmaf(p, dd.y, dva[4 * c + 1]);
          dva[4 * c + 2] = fmaf(p, dd.z, dva[4 * c + 2]);
          dva[4 * c + 3] = fmaf(p, dd.w, dva[4 * c + 3]);
          dka[4 * c] = fmaf(ds, qq.x, dka[4 * c]);
          dka[4 * c + 1] = fmaf(ds, qq.y, dka[4 * c + 1]);
          dka[4 * c + 2] = fmaf(ds, qq.z, dka[4 * c + 2]);
          dka[4 * c + 3] = fmaf(ds, qq.w, dka[4 * c + 3]);
        }
      }
    }
  }
  if (key_ok) {
    const int64_t base = (static_cast<int64_t>(bh) * Skv + key) * D;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d0 + d < D) {
        store(dk + base + d0 + d, dka[d] * scale);
        store(dv + base + d0 + d, dva[d]);
      }
    }
  }
}

// (c) dQ.  RQ rows a CTA, TPR threads a row; BK keys a tile.
template <typename T, int DH, int TPR, int RQ, int BK>
__global__ void __launch_bounds__(TPR * RQ, 1)
attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                 float scale, int causal, int window, int kv_offset) {
  constexpr int kThreads = TPR * RQ;
  __shared__ __align__(16) float ks[BK][TPR][DH + 4];
  __shared__ __align__(16) float vs[BK][TPR][DH + 4];

  const int nqb = (Sq + RQ - 1) / RQ;
  const int bh = blockIdx.x % BHq;
  // the last query blocks first: under a causal mask they see the most keys
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / BHq);
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int part = threadIdx.x % TPR;
  const int row = qb * RQ + threadIdx.x / TPR;
  const bool row_ok = row < Sq;
  const int pos = row + kv_offset;
  const int d0 = part * DH;

  float qr[DH], dor[DH], dqa[DH];
  const int64_t base = (static_cast<int64_t>(bh) * Sq + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const bool ok = row_ok && d0 + d < D;
    qr[d] = ok ? load(q + base + d0 + d) : 0.f;
    dor[d] = ok ? load(dO + base + d0 + d) : 0.f;
    dqa[d] = 0.f;
  }
  const float lrow = row_ok ? lse[static_cast<int64_t>(bh) * Sq + row] : 0.f;
  const float drow = row_ok ? delta[static_cast<int64_t>(bh) * Sq + row] : 0.f;

  // the keys some row of this CTA can see
  const int first = qb * RQ + kv_offset;
  const int last = min(qb * RQ + RQ, Sq) - 1 + kv_offset;
  const int k_end = causal ? min(Skv, last + 1) : Skv;
  const int k_beg = window > 0 ? max(0, first - window + 1) : 0;

  const T* kb = k + static_cast<int64_t>(kvh) * Skv * D;
  const T* vb = v + static_cast<int64_t>(kvh) * Skv * D;
  for (int t0 = (k_beg / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();
    load_tile<T, BK, DH, TPR, kThreads>(ks, kb, t0, Skv, D);
    load_tile<T, BK, DH, TPR, kThreads>(vs, vb, t0, Skv, D);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float4* k4 = reinterpret_cast<const float4*>(&ks[j][part][0]);
      const float4* v4 = reinterpret_cast<const float4*>(&vs[j][part][0]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 kk = k4[c], vv = v4[c];
        s = fmaf(qr[4 * c], kk.x, s);
        s = fmaf(qr[4 * c + 1], kk.y, s);
        s = fmaf(qr[4 * c + 2], kk.z, s);
        s = fmaf(qr[4 * c + 3], kk.w, s);
        dp = fmaf(dor[4 * c], vv.x, dp);
        dp = fmaf(dor[4 * c + 1], vv.y, dp);
        dp = fmaf(dor[4 * c + 2], vv.z, dp);
        dp = fmaf(dor[4 * c + 3], vv.w, dp);
      }
#pragma unroll
      for (int m = 1; m < TPR; m <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, m);
        dp += __shfl_xor_sync(0xffffffffu, dp, m);
      }
      const bool ok = row_ok && visible(t0 + j, pos, Skv, causal, window);
      const float p = ok ? expf(s * scale - lrow) : 0.f;
      const float ds = p * (dp - drow);
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 kk = k4[c];
        dqa[4 * c] = fmaf(ds, kk.x, dqa[4 * c]);
        dqa[4 * c + 1] = fmaf(ds, kk.y, dqa[4 * c + 1]);
        dqa[4 * c + 2] = fmaf(ds, kk.z, dqa[4 * c + 2]);
        dqa[4 * c + 3] = fmaf(ds, kk.w, dqa[4 * c + 3]);
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d0 + d < D) store(dq + base + d0 + d, dqa[d] * scale);
  }
}

// DH columns a thread, TPR threads a key or row; at most 256 threads a CTA
// (KB keys, RQ rows); BQ / BK rows a shared tile, two tiles under the
// 48 KB of static shared memory.
template <typename T, int DH, int TPR>
cudaError_t launch_dh(int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                      float scale, int causal, int window, int kv_offset,
                      const T* q, const T* k, const T* v, const T* o,
                      const T* dO, const float* lse, float* delta, T* dq,
                      T* dk, T* dv, cudaStream_t stream) {
  constexpr int kRows = (256 / TPR < 64) ? 256 / TPR : 64;  // KB = RQ
  constexpr int kTile = (TPR * (DH + 4) <= 160) ? 32 : 16;  // BQ = BK
  static_assert(2 * kTile * TPR * (DH + 4) * 4 + 2 * kTile * 4 <= 48 * 1024,
                "two tiles must fit the static shared memory");
  const int64_t rows = static_cast<int64_t>(BHq) * Sq;
  const int BHkv = BHq / Hq * Hkv;
  const int64_t blocks_a = (rows + 7) / 8;
  const int64_t blocks_b =
      static_cast<int64_t>(BHkv) * ((Skv + kRows - 1) / kRows);
  const int64_t blocks_c =
      static_cast<int64_t>(BHq) * ((Sq + kRows - 1) / kRows);
  const int64_t most = blocks_a > blocks_b ? blocks_a : blocks_b;
  if ((most > blocks_c ? most : blocks_c) >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  attention_bwd_delta<T><<<static_cast<unsigned>(blocks_a), 256, 0, stream>>>(
      o, dO, delta, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attention_bwd_dkdv<T, DH, TPR, kRows, kTile>
      <<<static_cast<unsigned>(blocks_b), TPR * kRows, 0, stream>>>(
          q, k, v, dO, lse, delta, dk, dv, BHkv, Hq, Hkv, Sq, Skv, D, scale,
          causal, window, kv_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attention_bwd_dq<T, DH, TPR, kRows, kTile>
      <<<static_cast<unsigned>(blocks_c), TPR * kRows, 0, stream>>>(
          q, k, v, dO, lse, delta, dq, BHq, Hq, Hkv, Sq, Skv, D, scale,
          causal, window, kv_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                   float scale, int causal, int window, int kv_offset,
                   const void* q, const void* k, const void* v, const void* o,
                   const void* dO, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(o);
  const T* dp = static_cast<const T*>(dO);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
#define EARL_BWD(DH, TPR)                                                   \
  launch_dh<T, DH, TPR>(BHq, Hq, Hkv, Sq, Skv, D, scale, causal, window,    \
                        kv_offset, qp, kp, vp, op, dp, lse, delta, dqp, dkp, \
                        dvp, stream)
  if (D <= 8) return EARL_BWD(8, 1);
  if (D <= 16) return EARL_BWD(16, 1);
  if (D <= 32) return EARL_BWD(16, 2);
  if (D <= 64) return EARL_BWD(16, 4);
  if (D <= 128) return EARL_BWD(32, 4);
  if (D <= 192) return EARL_BWD(24, 8);
  if (D <= 256) return EARL_BWD(32, 8);
#undef EARL_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window: 0 for none; D up to 256.  q, o, dO
// and dq are (BHq, Sq, D), k, v, dk and dv (BHq / Hq · Hkv, Skv, D), lse and
// the scratch delta (BHq, Sq) f32; all contiguous.
extern "C" int earl_flash_attention_bwd(int dtype, int BHq, int Hq, int Hkv,
                                        int Sq, int Skv, int D, float scale,
                                        int causal, int window, int kv_offset,
                                        void* q, void* k, void* v, void* o,
                                        void* dO, void* lse, void* delta,
                                        void* dq, void* dk, void* dv,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaError_t err =
      dtype == 0
          ? launch<float>(BHq, Hq, Hkv, Sq, Skv, D, scale, causal, window,
                          kv_offset, q, k, v, o, dO, lp, dl, dq, dk, dv, s)
          : launch<__nv_bfloat16>(BHq, Hq, Hkv, Sq, Skv, D, scale, causal,
                                  window, kv_offset, q, k, v, o, dO, lp, dl,
                                  dq, dk, dv, s);
  return static_cast<int>(err);
}
