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
// dk and dv in the inputs' dtype, accumulated in f32.  Masks as the
// forward's: key c is visible to query row r (absolute position r +
// kv_offset) when c < Skv, r < Sq, c <= r + kv_offset (causal) and c > r +
// kv_offset - window (a window > 0).  The KV head of query head h of batch
// b is b·Hkv + h / (Hq / Hkv).  For each visible pair: P = exp(scale·q·kᵀ
// − lse), dP = dO·vᵀ, dS = P ∘ (dP − Δ) with Δ = rowsum(dO ∘ O); dV +=
// P·dO, dK += scale·dS·q, dQ += scale·dS·k.  A row that sees no key has
// lse = -inf, P = 0 and zero gradients.
//
// Bound: five products of 2·D operations a visible pair (S, dP, dV, dK,
// dQ), 10·D; the bytes (q, k, v, o, dO, lse once, dq, dk, dv once) take
// far less time.  Each route has three launches: (a) a pass over the rows
// for Δ; (b) dK and dV, a CTA per (b·hkv, block of keys) walking the
// group's Hq / Hkv query heads and, for each, the query tiles that can
// see its keys, in a fixed order; (c) dQ, a CTA per (b·hq, block of query
// rows) walking the key tiles its rows can see.  (b) and (c) each
// recompute S and dP, so the card does 14·D operations a pair, not 10·D:
// the price of a fixed order without atomics (a single pass would add dQ
// across the key blocks' CTAs with atomics, in an order that changes from
// run to run).  Two launches give the same bits.  Fusing the passes is
// later work.  Two routes, chosen by dtype and D:
//
// bf16 up to D = 128 (attention_bwd_dkdv_tc<DP, BQ, STAGES> and
// attention_bwd_dq_tc<DP, BN, STAGES>): every product on the tensor cores
// (wgmma, bf16 operands, f32 accumulators), fed by TMA, built from the
// forward's pieces (wgmma_tile.cuh).  D is padded to DP = 64 or 128 by the
// TMA's zero fill through 3-D tensor maps (D, S, B·H), 128-byte swizzle;
// D = 120 reads 8 zero columns, and only the D columns are written.
// (a) attention_bwd_prep writes, for each row, lse₂ = lse·log2 e (+inf
// for a row that sees no key and for the rows past Sq, up to Sq rounded
// to 128) and Δ (0 past Sq), so both passes take P = exp2(scale·log2 e·s −
// lse₂), as the forward works in the log2 domain, and a row that sees no
// key or lies past Sq gets P = exp2(-inf) = 0, never exp2(+inf).  (b) A
// CTA owns 128 keys as two warpgroups of 64 (wgmma's M is the keys
// throughout); K and V are loaded once, and the query tiles (Q, dO, and
// their rows' lse₂ and Δ by 1-D bulk copies) go through a ring of STAGES
// stages of BQ rows.  Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma m64nBQk16 with
// both operands K-major, as the forward's S = Q·Kᵀ; Pᵀ and dSᵀ = Pᵀ ∘
// (dPᵀ − Δ) are computed in the accumulators' registers, rounded to bf16
// (RNE), already wgmma's register A fragments, and dV += Pᵀ·dO, dK +=
// dSᵀ·Q are wgmma m64nDPk16 with dO and Q read MN-major (the transpose
// bit), as the forward's P·V reads V.  Registers: the dK and dV
// accumulators take DP/2 each and Sᵀ and dPᵀ BQ/2 each, 192 at DP = 128
// with BQ = 64 and at DP = 64 with BQ = 128 (254 registers, no spill).
// The first key blocks first: under a causal mask they see the most rows.
// (c) A CTA owns 128 query rows as two warpgroups; Q and dO are loaded
// once, K and V go through a ring of BN-key tiles; S = Q·Kᵀ and dP =
// dO·Vᵀ are wgmma with both operands K-major, dS is rounded to bf16 in
// registers and dQ += dS·K reads K MN-major; BN = 64.  The last query
// blocks first, as in the forward.  At DP = 64, BQ = 128 and BN = 64
// measured 14% faster than 64 and 128, and one stage 40% slower than two
// at both DP (probe_slots.py --attention-bwd, PERF.md §6).  Only a tile that a causal, window or Skv edge
// cuts is masked element by element (the rows past Sq have P = 0 through
// lse₂).  P and dS are rounded to bf16 before the three products that
// take them, one rounding of one factor of each term: a relative 2^-8 of
// Σ|terms| at most.  Simple first, as the forward: no producer warp, no
// ping-pong; both warpgroups meet at a __syncthreads() after each tile,
// before its stage is refilled.
//
// f32, and bf16 past D = 128 (attention_bwd_dkdv / attention_bwd_dq<T,
// DH, TPR, ...>): the CUDA cores in IEEE f32 FMAs (no TF32, no fast
// math), the f32 route being the IEEE oracle as the forward's
// attention_f32 is.  Each thread owns one key (b) or one query row (c)
// and DH of its D columns (TPR threads a key or row, neighbouring lanes,
// their partial dot products summed by shuffles); the operand it walks
// over (q and dO tiles in (b), k and v tiles in (c)) sits in shared
// memory, each row's parts DH + 4 floats apart so that the float4 reads
// of a row's parts fall on different banks.  Threads a CTA stay at or
// under 256 (launch bounds of one CTA an SM), so a thread may hold 4·DH
// (b) or 3·DH (c) f32 registers of its row without spilling.  The bf16
// instances past D = 128 (gemma3-27b's 168, recurrentgemma-2b's 256) are
// the next to move onto the tensor cores (ROADMAP.md §2).
#include <cstdint>
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tile.cuh"

namespace {

using namespace earl;

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


// ---------------------------------------------------------------------------
// bf16 up to D = 128: tensor cores (wgmma), fed by TMA
// ---------------------------------------------------------------------------
constexpr int kTcBlock = 128;    // keys (b) or query rows (c) a CTA owns
constexpr int kTcThreads = 256;  // two consumer warpgroups of 64
constexpr int kTcMaxD = 128;     // the widest D of this route

// The dynamic shared memory a CTA of (b) or (c) takes: the two 128-row
// tiles it keeps (K and V, or Q and dO), STAGES pairs of `rows`-row tiles
// of its ring, and 1 KB to align the first box to the 1,024 bytes the
// 128-byte swizzle repeats on.
__host__ __device__ constexpr int tc_smem(int DP, int rows, int STAGES) {
  return 2 * tile_bytes(DP, kTcBlock) + 2 * STAGES * tile_bytes(DP, rows) +
         1024;
}

// Rows rounded up to the CTA block: the length of each row's lse₂ and Δ
// in the scratch, so every tile of (b) and every block of (c) reads whole.
__host__ __device__ constexpr int padded_rows(int Sq) {
  return (Sq + kTcBlock - 1) / kTcBlock * kTcBlock;
}

// (a) lse₂ and Δ into `lsd`: (BHq, Sq_pad) f32 each, lse₂ first.  Eight
// rows a CTA of 256 threads, a warp a row.
__global__ void __launch_bounds__(256)
attention_bwd_prep(const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dO,
                   const float* __restrict__ lse, float* __restrict__ lsd,
                   int BHq, int Sq, int D) {
  const int Sq_pad = padded_rows(Sq);
  const int64_t rows = static_cast<int64_t>(BHq) * Sq_pad;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const int64_t bh = row / Sq_pad;
  const int r = static_cast<int>(row - bh * Sq_pad);
  float s = 0.f;
  if (r < Sq) {
    const __nv_bfloat16* orow = o + (bh * Sq + r) * D;
    const __nv_bfloat16* drow = dO + (bh * Sq + r) * D;
    for (int d = lane; d < D; d += 32)
      s = fmaf(__bfloat162float(orow[d]), __bfloat162float(drow[d]), s);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    const float l = r < Sq ? lse[bh * Sq + r] : -INFINITY;
    lsd[row] = l > -INFINITY ? l * kLog2e : INFINITY;
    lsd[rows + row] = s;
  }
}

// P = exp2(s·scale·log2 e − lse₂) of a score, 0 where the pair is masked.
__device__ __forceinline__ float prob(float s, float scale_log2, float l2,
                                      bool masked, int key, int pos,
                                      int Skv, int causal, int window) {
  const float p = fast_exp2(s * scale_log2 - l2);
  return !masked || visible(key, pos, Skv, causal, window) ? p : 0.f;
}

// Columns 16kk .. 16kk + 15 of a 64 x N accumulator in bf16: the register
// A fragment of k-step kk (wgmma_tile.cuh).
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Rows r0 and r0 + 8 of a 64 x DP accumulator, times `mul`, into the D
// columns of (rows, D) bf16 rows at `out` (rows past `n` are not written).
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           __nv_bfloat16* out, int r0,
                                           int n, int D, float mul, int c0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    __nv_bfloat16* orow = out + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int n8 = 0; n8 < DP / 8; ++n8) {
      const int col = 8 * n8 + c0;  // D is a multiple of 8: col + 1 < D
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * n8 + 2 * i] * mul,
                                  acc[4 * n8 + 2 * i + 1] * mul);
    }
  }
}

// (b) dK and dV.  DP: the padded head dimension, 64 or 128; BQ: query rows
// a ring tile holds, 64 or 128; STAGES: the ring's depth.  D: the head
// dimension of the rows (a multiple of 8).  scale_log2: scale times log2 e.
template <int DP, int BQ, int STAGES>
__global__ void __launch_bounds__(kTcThreads, 1)
attention_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const float* __restrict__ lsd,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int BHq, int BHkv,
                      int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                      float scale_log2, int causal, int window,
                      int kv_offset) {
  constexpr int kBoxes = DP / kBoxCols;
  constexpr int kKBox = kTcBlock * kRowBytes;  // a box of K or V
  constexpr int kQBox = BQ * kRowBytes;        // a box of Q or dO
  constexpr int kKTile = tile_bytes(DP, kTcBlock);
  constexpr int kQTile = tile_bytes(DP, BQ);
  constexpr int kAcc = DP / 2;  // dK or dV entries a thread holds
  constexpr int kS = BQ / 2;    // Sᵀ or dPᵀ entries a thread holds
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  __shared__ __align__(16) float lds[STAGES][2][BQ];  // a tile's lse₂, Δ

  // K, V, then stage s's Q and dO tiles
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + kKTile;
  auto sq = [&](int s) { return sk + 2 * kKTile + 2 * s * kQTile; };
  auto sdo = [&](int s) { return sk + 2 * kKTile + (2 * s + 1) * kQTile; };
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto bar_q = [&](int s) { return smem_u32(&bars[1 + s]); };

  const int bh = blockIdx.x % BHkv;  // b·Hkv + kv head
  // the first key blocks first: under a causal mask they see the most rows
  const int kb = blockIdx.x / BHkv;
  const int b = bh / Hkv, hkv = bh % Hkv;
  const int G = Hq / Hkv;
  const int k0 = kb * kTcBlock;
  const int Sq_pad = padded_rows(Sq);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // keys k0 + 64·wg .. + 63
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int r0 = k0 + 64 * wg + 16 * warp + (lane >> 2);  // this thread's keys
  const int c0 = 2 * (lane & 3);
  const int wk0 = k0 + 64 * wg;

  // the query rows some key of this block is visible to: causal, a row at
  // or past the first key; windowed, before the last key + window
  const int key_last = min(k0 + kTcBlock, Skv) - 1;
  const int r_beg = causal ? max(0, k0 - kv_offset) : 0;
  const int r_end =
      window > 0 ? min(Sq, key_last + window - kv_offset) : Sq;  // exclusive
  const int t_first = r_beg / BQ;
  const int n_t = r_end > r_beg ? (r_end + BQ - 1) / BQ - t_first : 0;
  const int n_tiles = G * n_t;  // head g's tiles are j = g·n_t .. + n_t - 1

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_q(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* qm = &qmap;  // the maps stay in parameter space
  const CUtensorMap* km = &kmap;
  const CUtensorMap* vm = &vmap;
  const CUtensorMap* dom = &domap;
  const float* lse2 = lsd;
  const float* delta = lsd + static_cast<int64_t>(BHq) * Sq_pad;
  auto load_q = [&](int j) {  // tile j of this CTA's walk, by thread 0
    const int s = j % STAGES;
    const int bhq = b * Hq + hkv * G + j / n_t;
    const int row0 = (t_first + j % n_t) * BQ;
    mbar_expect_tx(bar_q(s), 2 * kQTile + 2 * BQ * 4);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sq(s) + bb * kQBox, qm, bar_q(s), bb * kBoxCols, row0, bhq);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sdo(s) + bb * kQBox, dom, bar_q(s), bb * kBoxCols, row0, bhq);
    const int64_t at = static_cast<int64_t>(bhq) * Sq_pad + row0;
    bulk_load(smem_u32(&lds[s][0][0]), lse2 + at, BQ * 4, bar_q(s));
    bulk_load(smem_u32(&lds[s][1][0]), delta + at, BQ * 4, bar_q(s));
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_kv, 2 * kKTile);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sk + bb * kKBox, km, bar_kv, bb * kBoxCols, k0, bh);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sv + bb * kKBox, vm, bar_kv, bb * kBoxCols, k0, bh);
    for (int j = 0; j < STAGES && j < n_tiles; ++j) load_q(j);
  }

  float dka[kAcc], dva[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dka[i] = dva[i] = 0.f;
  if (n_tiles > 0) mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int row0 = (t_first + j % n_t) * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: DP / 16 k-steps each; a k-step is 32
    // bytes into a box row
    float st[kS], dpt[kS];
    mbar_wait(bar_q(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(st,
               smem_desc(sk + wg * 64 * kRowBytes + (kk / 4) * kKBox + col,
                         16, 1024),
               smem_desc(sq(s) + (kk / 4) * kQBox + col, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(dpt,
               smem_desc(sv + wg * 64 * kRowBytes + (kk / 4) * kKBox + col,
                         16, 1024),
               smem_desc(sdo(s) + (kk / 4) * kQBox + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    // Pᵀ and dSᵀ: st[4·n8 + 2·i + e] is key r0 + 8i, query row row0 + 8·n8
    // + c0 + e; the warpgroup's keys see every row of the tile (no mask)
    // when they end before Skv, at or before its first row's diagonal, and
    // after its last row's window
    const bool masked =
        !(wk0 + 64 <= Skv && (!causal || wk0 + 63 <= row0 + kv_offset) &&
          (window <= 0 || wk0 > row0 + BQ - 1 + kv_offset - window));
#pragma unroll
    for (int n8 = 0; n8 < BQ / 8; ++n8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n8 + c0 + e;
        const float l2 = lds[s][0][col], dl = lds[s][1][col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * n8 + 2 * i + e;
          const float p = prob(st[x], scale_log2, l2, masked, r0 + 8 * i,
                               row0 + col + kv_offset, Skv, causal, window);
          dpt[x] = p * (dpt[x] - dl);
          st[x] = p;
        }
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    pack_a<BQ>(st, pa);
    pack_a<BQ>(dpt, da);

    // dV += Pᵀ·dO and dK += dSᵀ·Q: k-step kk is query rows 16kk .. 16kk +
    // 15, 2,048 bytes into a box; N = DP spans the boxes, kQBox apart
    reg_fence(dva);
    reg_fence(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dva, pa[kk], smem_desc(sdo(s) + kk * 2048, kQBox, 1024));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs(dka, da[kk], smem_desc(sq(s) + kk * 2048, kQBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dva);
    reg_fence(dka);

    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && j + STAGES < n_tiles) load_q(j + STAGES);
  }

  const int64_t base = static_cast<int64_t>(bh) * Skv * D;
  store_rows<DP>(dka, dk + base, r0, Skv, D, scale, c0);
  store_rows<DP>(dva, dv + base, r0, Skv, D, 1.f, c0);
}

// (c) dQ.  DP as in (b); BN: keys a ring tile holds, 64 or 128; STAGES:
// the ring's depth.
template <int DP, int BN, int STAGES>
__global__ void __launch_bounds__(kTcThreads, 1)
attention_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lsd,
                    __nv_bfloat16* __restrict__ dq, int BHq, int Hq, int Hkv,
                    int Sq, int Skv, int D, float scale, float scale_log2,
                    int causal, int window, int kv_offset) {
  constexpr int kBoxes = DP / kBoxCols;
  constexpr int kQBox = kTcBlock * kRowBytes;  // a box of Q or dO
  constexpr int kKVBox = BN * kRowBytes;       // a box of K or V
  constexpr int kQTile = tile_bytes(DP, kTcBlock);
  constexpr int kKVTile = tile_bytes(DP, BN);
  constexpr int kAcc = DP / 2;  // dQ entries a thread holds
  constexpr int kS = BN / 2;    // S or dP entries a thread holds
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];

  // Q, dO, then stage s's K and V tiles
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + kQTile;
  auto sk = [&](int s) { return sq + 2 * kQTile + 2 * s * kKVTile; };
  auto sv = [&](int s) { return sq + 2 * kQTile + (2 * s + 1) * kKVTile; };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kv = [&](int s) { return smem_u32(&bars[1 + s]); };

  const int nqb = (Sq + kTcBlock - 1) / kTcBlock;
  const int bh = blockIdx.x % BHq;
  // the last query blocks first: under a causal mask they see the most keys
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / BHq);
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = qb * kTcBlock;
  const int Sq_pad = padded_rows(Sq);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // rows q0 + 64·wg .. + 63
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);

  // the key tiles some row of this CTA can see
  const int first = q0 + kv_offset;
  const int last = min(q0 + kTcBlock, Sq) - 1 + kv_offset;
  const int k_end = causal ? min(Skv, last + 1) : Skv;
  const int k_beg = window > 0 ? max(0, first - window + 1) : 0;
  const int t_first = k_beg / BN;
  const int n_tiles = k_end > k_beg ? (k_end + BN - 1) / BN - t_first : 0;
  const int wg_first = q0 + 64 * wg + kv_offset;

  // this thread's rows' lse₂ and Δ (rows past Sq: +inf and 0)
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t at = static_cast<int64_t>(bh) * Sq_pad + r0 + 8 * i;
    l2[i] = lsd[at];
    dl[i] = lsd[static_cast<int64_t>(BHq) * Sq_pad + at];
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_kv(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* qm = &qmap;
  const CUtensorMap* km = &kmap;
  const CUtensorMap* vm = &vmap;
  const CUtensorMap* dom = &domap;
  auto load_kv = [&](int j) {  // tile j of this CTA's walk, by thread 0
    const int s = j % STAGES;
    const int key0 = (t_first + j) * BN;
    mbar_expect_tx(bar_kv(s), 2 * kKVTile);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sk(s) + bb * kKVBox, km, bar_kv(s), bb * kBoxCols, key0, kvh);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sv(s) + bb * kKVBox, vm, bar_kv(s), bb * kBoxCols, key0, kvh);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * kQTile);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sq + bb * kQBox, qm, bar_q, bb * kBoxCols, q0, bh);
#pragma unroll
    for (int bb = 0; bb < kBoxes; ++bb)
      tma_load(sdo + bb * kQBox, dom, bar_q, bb * kBoxCols, q0, bh);
    for (int j = 0; j < STAGES && j < n_tiles; ++j) load_kv(j);
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int t0 = (t_first + j) * BN;

    // S = Q·Kᵀ and dP = dO·Vᵀ
    float sc[kS], dp[kS];
    mbar_wait(bar_kv(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(sc,
               smem_desc(sq + wg * 64 * kRowBytes + (kk / 4) * kQBox + col,
                         16, 1024),
               smem_desc(sk(s) + (kk / 4) * kKVBox + col, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(dp,
               smem_desc(sdo + wg * 64 * kRowBytes + (kk / 4) * kQBox + col,
                         16, 1024),
               smem_desc(sv(s) + (kk / 4) * kKVBox + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    // dS: sc[4·n8 + 2·i + e] is row r0 + 8i, key t0 + 8·n8 + c0 + e
    const bool masked =
        !(t0 + BN <= Skv && (!causal || t0 + BN - 1 <= wg_first) &&
          (window <= 0 || t0 > wg_first + 63 - window));
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * n8 + 2 * i + e;
          const float p = prob(sc[x], scale_log2, l2[i], masked,
                               t0 + 8 * n8 + c0 + e, r0 + 8 * i + kv_offset,
                               Skv, causal, window);
          sc[x] = p * (dp[x] - dl[i]);
        }
      }
    }
    uint32_t da[BN / 16][4];
    pack_a<BN>(sc, da);

    // dQ += dS·K: K read MN-major, as the forward's P·V reads V
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(acc, da[kk], smem_desc(sk(s) + kk * 2048, kKVBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);

    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && j + STAGES < n_tiles) load_kv(j + STAGES);
  }

  store_rows<DP>(acc, dq + static_cast<int64_t>(bh) * Sq * D, r0, Sq, D,
                 scale, c0);
}

// The three launches of the tensor-core route: (b) with BQ-row query
// tiles in STAGES stages, (c) with BN-key tiles in STAGES stages.
template <int DP, int BQ, int BN, int STAGES>
cudaError_t launch_tc_dp(int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                         float scale, int causal, int window, int kv_offset,
                         const void* q, const void* k, const void* v,
                         const void* o, const void* dO, const float* lse,
                         float* lsd, void* dq, void* dk, void* dv,
                         cudaStream_t stream) {
  constexpr int smem_b = tc_smem(DP, BQ, STAGES);
  constexpr int smem_c = tc_smem(DP, BN, STAGES);
  static_assert(smem_b + 2 * STAGES * BQ * 4 + 64 <= 232448 &&
                    smem_c + 64 <= 232448,
                "a CTA's shared memory is past the 227 KB Hopper gives");
  const int BHkv = BHq / Hq * Hkv;
  const int64_t rows = static_cast<int64_t>(BHq) * padded_rows(Sq);
  const int64_t blocks_a = (rows + 7) / 8;
  const int64_t blocks_b =
      static_cast<int64_t>(BHkv) * ((Skv + kTcBlock - 1) / kTcBlock);
  const int64_t blocks_c =
      static_cast<int64_t>(BHq) * ((Sq + kTcBlock - 1) / kTcBlock);
  const int64_t most = blocks_a > blocks_b ? blocks_a : blocks_b;
  if ((most > blocks_c ? most : blocks_c) >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  // Q and dO in BQ-row boxes for (b) and 128-row boxes for (c); K and V
  // in 128-row boxes for (b) and BN-row boxes for (c)
  CUtensorMap qb, dob, kb, vb, qc, doc, kc, vc;
  if (!tensor_map(&qb, q, D, Sq, BHq, BQ) ||
      !tensor_map(&dob, dO, D, Sq, BHq, BQ) ||
      !tensor_map(&kb, k, D, Skv, BHkv, kTcBlock) ||
      !tensor_map(&vb, v, D, Skv, BHkv, kTcBlock) ||
      !tensor_map(&qc, q, D, Sq, BHq, kTcBlock) ||
      !tensor_map(&doc, dO, D, Sq, BHq, kTcBlock) ||
      !tensor_map(&kc, k, D, Skv, BHkv, BN) ||
      !tensor_map(&vc, v, D, Skv, BHkv, BN))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_dkdv_tc<DP, BQ, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attention_bwd_dq_tc<DP, BN, STAGES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_c);
  if (e != cudaSuccess) return e;
  const float scale_log2 = scale * kLog2e;
  const __nv_bfloat16* op = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* dp = static_cast<const __nv_bfloat16*>(dO);
  attention_bwd_prep<<<static_cast<unsigned>(blocks_a), 256, 0, stream>>>(
      op, dp, lse, lsd, BHq, Sq, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attention_bwd_dkdv_tc<DP, BQ, STAGES>
      <<<static_cast<unsigned>(blocks_b), kTcThreads, smem_b, stream>>>(
          qb, kb, vb, dob, lsd, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), BHq, BHkv, Hq, Hkv, Sq, Skv, D,
          scale, scale_log2, causal, window, kv_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attention_bwd_dq_tc<DP, BN, STAGES>
      <<<static_cast<unsigned>(blocks_c), kTcThreads, smem_c, stream>>>(
          qc, kc, vc, doc, lsd, static_cast<__nv_bfloat16*>(dq), BHq, Hq,
          Hkv, Sq, Skv, D, scale, scale_log2, causal, window, kv_offset);
  return cudaGetLastError();
}

cudaError_t launch_tc(int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                      float scale, int causal, int window, int kv_offset,
                      const void* q, const void* k, const void* v,
                      const void* o, const void* dO, const float* lse,
                      float* lsd, void* dq, void* dk, void* dv,
                      cudaStream_t stream) {
  // TMA reads rows of a multiple of 16 bytes from 16-byte aligned bases
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  if (D % 8 != 0 || D > kTcMaxD || !aligned(q) || !aligned(k) ||
      !aligned(v) || !aligned(dO) || !aligned(lsd))
    return cudaErrorInvalidValue;
#define EARL_TC_BWD(DP, BQ, BN, STAGES)                                    \
  launch_tc_dp<DP, BQ, BN, STAGES>(BHq, Hq, Hkv, Sq, Skv, D, scale,        \
                                   causal, window, kv_offset, q, k, v, o,  \
                                   dO, lse, lsd, dq, dk, dv, stream)
  return D <= 64 ? EARL_TC_BWD(64, 128, 64, 2) : EARL_TC_BWD(128, 64, 64, 2);
#undef EARL_TC_BWD
}

// f32 at every D, and bf16 past D = 128: the CUDA cores
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
  if constexpr (sizeof(T) == 4) {
    if (D <= 8) return EARL_BWD(8, 1);
    if (D <= 16) return EARL_BWD(16, 1);
    if (D <= 32) return EARL_BWD(16, 2);
    if (D <= 64) return EARL_BWD(16, 4);
    if (D <= 128) return EARL_BWD(32, 4);
  }
  if (D <= 192) return EARL_BWD(24, 8);
  if (D <= 256) return EARL_BWD(32, 8);
#undef EARL_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window: 0 for none; D up to 256.  q, o, dO
// and dq are (BHq, Sq, D), k, v, dk and dv (BHq / Hq · Hkv, Skv, D), lse
// (BHq, Sq) f32; all contiguous.  The scratch delta: (BHq, Sq) f32 for the
// CUDA-core route; for bf16 up to D = 128, the tensor-core route, 2 x BHq
// x Sq rounded up to 128 f32 and 16-byte aligned, with D a multiple of 8
// and q, k, v and dO 16-byte aligned.
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
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(BHq, Hq, Hkv, Sq, Skv, D, scale, causal, window,
                        kv_offset, q, k, v, o, dO, lp, dl, dq, dk, dv, s);
  else if (D <= kTcMaxD)
    err = launch_tc(BHq, Hq, Hkv, Sq, Skv, D, scale, causal, window,
                    kv_offset, q, k, v, o, dO, lp, dl, dq, dk, dv, s);
  else
    err = launch<__nv_bfloat16>(BHq, Hq, Hkv, Sq, Skv, D, scale, causal,
                                window, kv_offset, q, k, v, o, dO, lp, dl,
                                dq, dk, dv, s);
  return static_cast<int>(err);
}
