// Kernel 12: blockwise (flash) attention with causal and sliding-window
// masks, GQA and a query offset for cached decode.
//
// Replaces repro/kernels/flash_attention/kernel.py: flash_attention_kernel
// (body _fa_kernel).  q is (B·Hq, Sq, D), k and v are (B·Hkv, Skv, D), f32
// or bf16; the output is (B·Hq, Sq, D) in q's dtype.  Query row r sits at
// absolute position r + kv_offset; key c is visible to it when c < Skv,
// r < Sq, c <= r + kv_offset (causal) and c > r + kv_offset - window (a
// window > 0).  The running maximum m, the running sum l and the
// accumulator are f32, and the recurrence is the reference's: scores of
// masked keys are -1e30 before the maximum and their probabilities are 0
// after the exponential, so a tile with no visible key leaves the row
// unchanged, and a row with no visible key ends as acc / max(l, 1e-30) = 0.
// The KV head of query head h of batch b is b·Hkv + h / (Hq / Hkv): K/V are
// never repeated in memory.  A CTA visits only the key tiles some row of
// its own can see (the causal diagonal bounds the last, the window the
// first), and the grid walks (b·h, query block) flattened on gridDim.x,
// the last query blocks first: under a causal mask they see the most keys,
// so the last wave of CTAs is the lightest.
//
// With a non-null ``lse`` (a training forward), both routes also write each
// query row's log-sum-exp, m + log(l) in natural units (f32, (B·Hq, Sq);
// -inf for a row that sees no key), which the backward kernel
// (flash_attention_bwd.cu) reads; a null ``lse`` writes nothing more, and
// the output is the same either way.
//
// Bound: the two products, 4·D operations per visible (query, key) pair;
// the bytes (q, k, v and o once each) take far less time.  Two routes:
//
// bf16 (attention_tc<DP, BN, STAGES>): both products on the tensor cores.
// A CTA owns 128 query rows as two warpgroups of 64 (wgmma's M) and walks
// K/V tiles of BN keys.  D is padded to DP = 64, 128, 192 or 256 by the
// TMA's zero fill (head dim 120 is two 64-column boxes, the second reading
// 8 zero columns; 168 is three, the third reading 24), and q, k and v are
// read through 3-D tensor maps (D, S, B·H), so a box never crosses into
// the next head and the ragged Sq / Skv edges read zeros.  128-byte
// swizzle.  Q is loaded once; K and V go through a ring of STAGES stages,
// each with its own mbarrier per operand, so QKᵀ of a tile starts before
// its V has landed and, with two stages, the next tile's copies overlap
// this tile's work.  Up to DP = 128: BN = 128 keys, two stages.  Past it
// Q, K and V of 128-key tiles in two stages would take (1 + 2·2)·DP·256
// bytes, 241 KB at DP = 192, past the 227 KB a CTA may have, and the
// O accumulator is DP/2 f32 registers a thread (128 at DP = 256) beside
// S's BN/2: so BN = 64 keys in two stages (145 and 193 KB, S 32
// registers).  BN = 128 in one stage takes the same bytes and measured
// 11-25% slower (probe_slots.py --attention, PERF.md §6).  S = Q·Kᵀ
// is wgmma m64nBNk16 with both operands K-major in shared memory; the
// online softmax runs in the accumulator's registers (a row's
// max and sum reduced over the four threads of its quad) in the log2
// domain (scale·log2 e folded into the scores), masking only tiles that a
// causal, window or Skv edge cuts; masked scores are -inf, which with
// m starting at -1e30 is the reference's -1e30 / p = 0.  P is rounded to
// bf16 in registers, where the accumulator's layout is already wgmma's
// register A fragment, and O += P·V is wgmma with V read MN-major
// (transpose bit), so V stays (key, D) as TMA loaded it: m64nDPk16, its
// N spanning the DP/64 boxes of a V tile.  l sums the
// unrounded f32 P.  The output is O / max(l, 1e-30) rounded to bf16 (RNE).
// Fixed order, no atomics: two launches give the same bits.  Simple
// first: no producer warp and no ping-pong between the warpgroups; both
// meet at a __syncthreads() after each tile, before its stage is refilled.
// The mbarrier, TMA and wgmma pieces live in wgmma_tile.cuh, which the
// backward's tensor-core route shares.
//
// f32 (attention_f32<DH, TPR, BK>): IEEE f32 FMAs on the CUDA cores (the
// tensor cores' TF32 keeps 10 bits).  One CTA per (b·h, 64 query rows),
// TPR threads a row, each holding DH columns of the row's q and of the
// accumulator in registers (D padded with zeros), K/V tiles of BK keys
// walked through shared memory: two threads a row and 32 keys up to
// D = 128, four threads a row and 16 keys past it (DH = 48 or 64, so q and
// the accumulator stay at 2·DH registers; 16 keys keep the two tiles
// under the 48 KB of static shared memory).
#include <cstdint>
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tile.cuh"

namespace {

using namespace earl;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kF32BlockQ = 64;  // query rows a CTA owns

// DH: the columns of the padded head dimension a thread holds (a multiple
// of 4, for float4 reads of shared memory); TPR: threads a query row (a
// power of two, neighbouring lanes); BK: keys a shared-memory tile holds.
template <int DH, int TPR, int BK>
__global__ void __launch_bounds__(TPR * kF32BlockQ)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int BHq,
              int Hq, int Hkv, int Sq, int Skv, int D, float scale,
              int causal, int window, int kv_offset) {
  constexpr int kThreadsF32 = TPR * kF32BlockQ;
  // a key's parts sit 4 floats apart more than their width, so the float4
  // reads of the threads of a row fall on different banks
  constexpr int kStride = DH + 4;
  __shared__ __align__(16) float ks[BK][TPR][kStride];
  __shared__ __align__(16) float vs[BK][TPR][kStride];

  const int nqb = (Sq + kF32BlockQ - 1) / kF32BlockQ;
  const int bh = blockIdx.x % BHq;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / BHq);
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int part = threadIdx.x % TPR;
  const int row = qb * kF32BlockQ + threadIdx.x / TPR;
  const bool row_ok = row < Sq;
  const int pos = row + kv_offset;
  const int d0 = part * DH;

  float qr[DH], acc[DH];
  const float* qrow =
      q + (static_cast<int64_t>(bh) * Sq + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = (row_ok && d0 + d < D) ? qrow[d0 + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // the keys some row of this CTA can see
  const int first = qb * kF32BlockQ + kv_offset;
  const int last = min(qb * kF32BlockQ + kF32BlockQ, Sq) - 1 + kv_offset;
  const int k_end = causal ? min(Skv, last + 1) : Skv;
  const int k_beg = window > 0 ? max(0, first - window + 1) : 0;

  const float* kb = k + static_cast<int64_t>(kvh) * Skv * D;
  const float* vb = v + static_cast<int64_t>(kvh) * Skv * D;
  for (int t0 = (k_beg / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BK * TPR * DH; e += kThreadsF32) {
      const int j = e / (TPR * DH), dd = e - j * (TPR * DH);
      const int key = t0 + j;
      const bool ok = key < Skv && dd < D;
      const int64_t src = static_cast<int64_t>(key) * D + dd;
      ks[j][dd / DH][dd % DH] = ok ? kb[src] : 0.f;
      vs[j][dd / DH][dd % DH] = ok ? vb[src] : 0.f;
    }
    __syncthreads();

    float s[BK];
    unsigned live = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][part][0]);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 kk = kr[c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int m = 1; m < TPR; m <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, m);
      const int col = t0 + j;
      const bool ok = row_ok && col < Skv && (!causal || col <= pos) &&
                      (window <= 0 || col > pos - window);
      s[j] = ok ? dot * scale : kNegInf;
      live |= (ok ? 1u : 0u) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = ((live >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][part][0]);
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + (static_cast<int64_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d0 + d < D) orow[d0 + d] = acc[d] / denom;
    }
    if (lse != nullptr && part == 0)
      lse[static_cast<int64_t>(bh) * Sq + row] = m + logf(l);
  }
}

cudaError_t launch_f32(int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                       float scale, int causal, int window, int kv_offset,
                       const void* q, const void* k, const void* v, void* o,
                       float* lse, cudaStream_t stream) {
  const int64_t blocks =
      static_cast<int64_t>(BHq) * ((Sq + kF32BlockQ - 1) / kF32BlockQ);
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
#define EARL_FA(DH, TPR, BK)                                              \
  attention_f32<DH, TPR, BK><<<grid, TPR * kF32BlockQ, 0, stream>>>(      \
      qp, kp, vp, op, lse, BHq, Hq, Hkv, Sq, Skv, D, scale, causal,       \
      window, kv_offset)
  if (D <= 8) {
    EARL_FA(4, 2, 32);
  } else if (D <= 16) {
    EARL_FA(8, 2, 32);
  } else if (D <= 32) {
    EARL_FA(16, 2, 32);
  } else if (D <= 64) {
    EARL_FA(32, 2, 32);
  } else if (D <= 128) {
    EARL_FA(64, 2, 32);
  } else if (D <= 192) {
    EARL_FA(48, 4, 16);
  } else if (D <= 256) {
    EARL_FA(64, 4, 16);
  } else {
    return cudaErrorInvalidValue;
  }
#undef EARL_FA
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), fed by TMA
// ---------------------------------------------------------------------------
constexpr int kBlockM = 128;    // query rows a CTA owns: two warpgroups of 64
constexpr int kThreads = 256;   // two consumer warpgroups
// The dynamic shared memory a CTA takes: Q (128 rows), then STAGES (K, V)
// pairs of BN-row tiles, and 1 KB to align the first box to the 1,024
// bytes the 128-byte swizzle repeats on.
__host__ __device__ constexpr int smem_bytes(int DP, int BN, int STAGES) {
  return tile_bytes(DP, kBlockM) + 2 * STAGES * tile_bytes(DP, BN) + 1024;
}

// DP: the padded head dimension, 64, 128, 192 or 256; BN: keys a K/V tile
// holds, 64 or 128; STAGES: the K/V ring's depth.  D: the head dimension
// of the output rows (a multiple of 8).  scale_log2: the score scale times
// log2 e.
template <int DP, int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
attention_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int BHq,
             int Hq, int Hkv, int Sq, int Skv, int D, float scale_log2,
             int causal, int window, int kv_offset) {
  constexpr int kBoxes = DP / kBoxCols;
  constexpr int kQBox = kBlockM * kRowBytes;  // a box of Q: 128 rows
  constexpr int kKVBox = BN * kRowBytes;      // a box of K or V: BN rows
  constexpr int kQTile = tile_bytes(DP, kBlockM);
  constexpr int kKVTile = tile_bytes(DP, BN);
  constexpr int kAcc = DP / 2;  // O entries a thread holds: 64 x DP / 128
  constexpr int kS = BN / 2;    // S entries a thread holds: 64 x BN / 128
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];

  // Q, then stage s's K and V tiles
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_k = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_v = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto sk = [&](int s) { return sq + kQTile + 2 * s * kKVTile; };
  auto sv = [&](int s) { return sq + kQTile + (2 * s + 1) * kKVTile; };

  const int nqb = (Sq + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x % BHq;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / BHq);
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = qb * kBlockM;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                // rows q0 + 64·wg .. + 63
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  // this thread's rows (r0 and r0 + 8) and its first column in every
  // group of 8: wgmma's accumulator layout
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);

  // the key tiles some row of this CTA can see
  const int first = q0 + kv_offset;
  const int last = min(q0 + kBlockM, Sq) - 1 + kv_offset;
  const int k_end = causal ? min(Skv, last + 1) : Skv;
  const int k_beg = window > 0 ? max(0, first - window + 1) : 0;
  const int t_first = k_beg / BN;
  const int n_tiles = k_end > k_beg ? (k_end + BN - 1) / BN - t_first : 0;
  // the rows of this warpgroup see every key of a tile (no mask) when the
  // tile ends before Skv, before its first row's diagonal, and after its
  // last row's window
  const int wg_first = q0 + 64 * wg + kv_offset;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* qm = &qmap;  // the maps stay in parameter space
  const CUtensorMap* km = &kmap;
  const CUtensorMap* vm = &vmap;
  auto load_kv = [&](int j) {  // tile j of this CTA's walk, by thread 0
    const int s = j % STAGES;
    const int key0 = (t_first + j) * BN;
    mbar_expect_tx(bar_k(s), kKVTile);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b)
      tma_load(sk(s) + b * kKVBox, km, bar_k(s), b * kBoxCols, key0, kvh);
    mbar_expect_tx(bar_v(s), kKVTile);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b)
      tma_load(sv(s) + b * kKVBox, vm, bar_v(s), b * kBoxCols, key0, kvh);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, kQTile);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b)
      tma_load(sq + b * kQBox, qm, bar_q, b * kBoxCols, q0, bh);
    for (int j = 0; j < STAGES && j < n_tiles; ++j) load_kv(j);
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int t0 = (t_first + j) * BN;

    // S = Q·Kᵀ: D_pad / 16 k-steps; a k-step is 32 bytes into a box row
    float sc[kS];
    mbar_wait(bar_k(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(sc,
               smem_desc(sq + wg * 64 * kRowBytes + (kk / 4) * kQBox + col,
                         16, 1024),
               smem_desc(sk(s) + (kk / 4) * kKVBox + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);

    // online softmax: sc[4·n8 + 2·i + e] is row r0 + 8i, column
    // t0 + 8·n8 + c0 + e
    const bool masked =
        !(t0 + BN <= Skv && (!causal || t0 + BN - 1 <= wg_first) &&
          (window <= 0 || t0 > wg_first + 63 - window));
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = r0 + 8 * i + kv_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * n8 + 2 * i + e] * scale_log2;
          if (masked) {
            const int col = t0 + 8 * n8 + c0 + e;
            const bool ok = col < Skv && (!causal || col <= pos) &&
                            (window <= 0 || col > pos - window);
            x = ok ? x : -INFINITY;
          }
          sc[4 * n8 + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = fast_exp2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(sc[4 * n8 + 2 * i + e] - m_new);
          sc[4 * n8 + 2 * i + e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * alpha[i] + sum;  // this thread's columns; quad-summed last
      m[i] = m_new;
    }
#pragma unroll
    for (int n8 = 0; n8 < DP / 8; ++n8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * n8 + 2 * i] *= alpha[i];
        acc[4 * n8 + 2 * i + 1] *= alpha[i];
      }
    }
    // P in bf16 as wgmma's A fragments: k-step kk covers columns
    // 16kk .. 16kk + 15, i.e. accumulator groups n8 = 2kk and 2kk + 1
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P·V: k-step kk is keys 16kk .. 16kk + 15, 2,048 bytes into a
    // box; N = DP spans the boxes, kKVBox apart (the leading offset)
    mbar_wait(bar_v(s), parity);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(acc, pa[kk], smem_desc(sv(s) + kk * 2048, kKVBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);

    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && j + STAGES < n_tiles) load_kv(j + STAGES);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m is in log2 units with scale·log2 e folded in: m·ln 2 + log l
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<int64_t>(bh) * Sq + row] = m[i] * kLn2 + logf(l[i]);
    __nv_bfloat16* orow = o + (static_cast<int64_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int n8 = 0; n8 < DP / 8; ++n8) {
      const int col = 8 * n8 + c0;  // D is a multiple of 8: col + 1 < D
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * n8 + 2 * i] / denom,
                                  acc[4 * n8 + 2 * i + 1] / denom);
    }
  }
}


template <int DP, int BN, int STAGES>
cudaError_t launch_tc_dp(const void* q, const void* k, const void* v,
                         int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                         float scale_log2, int causal, int window,
                         int kv_offset, void* o, float* lse,
                         cudaStream_t stream) {
  static_assert(smem_bytes(DP, BN, STAGES) <= 232448,
                "a CTA's shared memory is past the 227 KB Hopper gives");
  const int64_t blocks =
      static_cast<int64_t>(BHq) * ((Sq + kBlockM - 1) / kBlockM);
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const int BHkv = BHq / Hq * Hkv;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, D, Sq, BHq, kBlockM) ||
      !tensor_map(&km, k, D, Skv, BHkv, BN) ||
      !tensor_map(&vm, v, D, Skv, BHkv, BN))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes(DP, BN, STAGES);
  const cudaError_t e = cudaFuncSetAttribute(
      attention_tc<DP, BN, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attention_tc<DP, BN, STAGES><<<static_cast<unsigned>(blocks), kThreads,
                                 smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, BHq, Hq, Hkv, Sq,
      Skv, D, scale_log2, causal, window, kv_offset);
  return cudaGetLastError();
}

cudaError_t launch_tc(int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                      float scale, int causal, int window, int kv_offset,
                      const void* q, const void* k, const void* v, void* o,
                      float* lse, cudaStream_t stream) {
  // TMA reads rows of a multiple of 16 bytes from 16-byte aligned bases
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  if (D % 8 != 0 || D > 256 || !aligned(q) || !aligned(k) || !aligned(v))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
#define EARL_TC(DP, BN, STAGES)                                            \
  launch_tc_dp<DP, BN, STAGES>(q, k, v, BHq, Hq, Hkv, Sq, Skv, D,          \
                               scale_log2, causal, window, kv_offset, o,   \
                               lse, stream)
  if (D <= 128) return D <= 64 ? EARL_TC(64, 128, 2) : EARL_TC(128, 128, 2);
  return D <= 192 ? EARL_TC(192, 64, 2) : EARL_TC(256, 64, 2);
#undef EARL_TC
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); window: 0 for
// none.  D up to 256; bf16 takes D a multiple of 8 and 16-byte aligned q,
// k, v.  lse: null, or (BHq, Sq) f32 for each row's log-sum-exp.
extern "C" int earl_flash_attention(int dtype, int BHq, int Hq, int Hkv,
                                    int Sq, int Skv, int D, float scale,
                                    int causal, int window, int kv_offset,
                                    void* q, void* k, void* v, void* o,
                                    void* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  const cudaError_t err =
      dtype == 0 ? launch_f32(BHq, Hq, Hkv, Sq, Skv, D, scale, causal,
                              window, kv_offset, q, k, v, o, lp, s)
                 : launch_tc(BHq, Hq, Hkv, Sq, Skv, D, scale, causal, window,
                             kv_offset, q, k, v, o, lp, s);
  return static_cast<int>(err);
}
