// Kernel 12: blockwise (flash) attention with causal and sliding-window
// masks, GQA and a query offset for cached decode.
//
// Replaces repro/kernels/flash_attention/kernel.py: flash_attention_kernel
// (body _fa_kernel).  q is (B·Hq, Sq, D), k and v are (B·Hkv, Skv, D), f32
// or bf16; the output is (B·Hq, Sq, D) in q's dtype.  Query row r sits at
// absolute position r + kv_offset; key c is visible to it when c < Skv,
// r < Sq, c <= r + kv_offset (causal) and c > r + kv_offset - window (a
// window > 0).  Every sum, the running maximum m, the running sum l and
// the accumulator are f32, and the recurrence is the reference's: scores
// of masked keys are -1e30 before the maximum and their probabilities are
// set to 0 after the exponential, so a tile with no visible key leaves the
// row unchanged, and a row with no visible key ends as acc / max(l, 1e-30)
// = 0.
//
// Bound: the two products, 4·D operations per visible (query, key) pair;
// the bytes (q, k, v and o once each) take far less time.  Design, for a
// first kernel that is right on CUDA-core FMAs (no tensor cores yet): one
// CTA per (b·h, 64 query rows), two threads a row, each holding its half
// of the row's q and of the accumulator in registers (D padded to a
// multiple of 8 with zeros, so head_dim 120 is 2 x 64 with 8 dead lanes
// masked on the store).  K/V tiles of 32 keys are walked in order through
// shared memory, converted to f32 on the load, and only the tiles some row
// of the CTA can see are loaded: the causal diagonal bounds the last, the
// window the first.  The KV head of query head h of batch b is
// b·Hkv + h / (Hq / Hkv): K/V are never repeated in memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;               // query rows a CTA owns
constexpr int kBlockK = 32;               // keys a shared-memory tile holds
constexpr int kThreads = 2 * kBlockQ;     // two threads a query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// DH: the half of the padded head dimension a thread holds (a multiple
// of 4, for float4 reads of shared memory).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, int D, float scale,
                       int causal, int window, int kv_offset) {
  // a key's two halves sit 4 floats apart more than their width, so the
  // float4 reads of the two threads of a row fall on different banks
  constexpr int kStride = DH + 4;
  __shared__ __align__(16) float ks[kBlockK][2][kStride];
  __shared__ __align__(16) float vs[kBlockK][2][kStride];

  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kBlockQ + (threadIdx.x >> 1);
  const bool row_ok = row < Sq;
  const int pos = row + kv_offset;
  const int d0 = half * DH;

  float qr[DH], acc[DH];
  const T* qrow = q + (static_cast<int64_t>(bh) * Sq + (row_ok ? row : 0)) *
                          D;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = (row_ok && d0 + d < D) ? to_f32(qrow[d0 + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // the keys some row of this CTA can see
  const int first = blockIdx.x * kBlockQ + kv_offset;
  const int last = min(blockIdx.x * kBlockQ + kBlockQ, Sq) - 1 + kv_offset;
  const int k_end = causal ? min(Skv, last + 1) : Skv;
  const int k_beg = window > 0 ? max(0, first - window + 1) : 0;

  const T* kb = k + static_cast<int64_t>(kvh) * Skv * D;
  const T* vb = v + static_cast<int64_t>(kvh) * Skv * D;
  for (int t0 = (k_beg / kBlockK) * kBlockK; t0 < k_end; t0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kBlockK * 2 * DH; e += kThreads) {
      const int j = e / (2 * DH), dd = e - j * (2 * DH);
      const int key = t0 + j;
      const bool ok = key < Skv && dd < D;
      const int64_t src = static_cast<int64_t>(key) * D + dd;
      ks[j][dd / DH][dd % DH] = ok ? to_f32(kb[src]) : 0.f;
      vs[j][dd / DH][dd % DH] = ok ? to_f32(vb[src]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    unsigned live = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][half][0]);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DH / 4; ++c) {
        const float4 kk = kr[c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
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
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = ((live >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][half][0]);
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
    T* orow = o + (static_cast<int64_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d0 + d < D) store(&orow[d0 + d], acc[d] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(int BHq, int Hq, int Hkv, int Sq, int Skv, int D,
                   float scale, int causal, int window, int kv_offset,
                   const void* q, const void* k, const void* v, void* o,
                   cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, BHq);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define EARL_FA(DH)                                                      \
  flash_attention_kernel<T, DH><<<grid, kThreads, 0, stream>>>(          \
      qp, kp, vp, op, Hq, Hkv, Sq, Skv, D, scale, causal, window,        \
      kv_offset)
  if (D <= 8) {
    EARL_FA(4);
  } else if (D <= 16) {
    EARL_FA(8);
  } else if (D <= 32) {
    EARL_FA(16);
  } else if (D <= 64) {
    EARL_FA(32);
  } else if (D <= 128) {
    EARL_FA(64);
  } else {
    return cudaErrorInvalidValue;
  }
#undef EARL_FA
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window: 0 for none.
extern "C" int earl_flash_attention(int dtype, int BHq, int Hq, int Hkv,
                                    int Sq, int Skv, int D, float scale,
                                    int causal, int window, int kv_offset,
                                    void* q, void* k, void* v, void* o,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(BHq, Hq, Hkv, Sq, Skv, D, scale, causal,
                                 window, kv_offset, q, k, v, o, s)
                 : launch<__nv_bfloat16>(BHq, Hq, Hkv, Sq, Skv, D, scale,
                                         causal, window, kv_offset, q, k, v,
                                         o, s);
  return static_cast<int>(err);
}
