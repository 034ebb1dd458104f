// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the argument block, tile shapes, shared-memory
// leading dimensions, dtype conversion, tile loads, warp reductions, and
// the score element's masks, bias and softmax-dropout hash.
//
// Layout: q, o, do and dq are (B, Sq, H, D) tensors, k, v, dk and dv are
// (B, Sk, H, D), each head row D contiguous elements; the kernels take each
// tensor's batch and row strides (elements), so q/k/v may be views of one
// packed (B, S, 3·H·D) projection. lse and delta are f32 (B·H, Sq). The
// optional f32 bias is read at (b, h, row, key) through four element
// strides, 0 on a broadcast dim, so a (B, 1, 1, Sk) padding mask is never
// expanded in memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace apex_flash {

constexpr int BM = 64;          // q rows per tile
constexpr int BN = 64;          // k rows per tile
constexpr int NWARPS = 4;       // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD_H = 8;        // pad (elements) of 16-bit tiles: 16 bytes
constexpr int PAD_F = 4;        // pad (elements) of f32 tiles: 16 bytes
// lse of a row that sees no key, as the JAX package's kernels give it
constexpr float NEG_INF = -1e30f;

// Everything a launch needs, for both directions. Mirrored field for field
// by apex_tpu_torch/ops/attention.py::_FlashArgs. A null bias, seed, dbo
// or causal_off pointer turns that option off (causal_off null: the
// frontier is off_static).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  const float* delta;
  const float* bias;
  const int* seed;          // dropout seed (int32, read on the device)
  const int* dbo;           // dropout (q-block, k-block) offsets
  const int* causal_off;    // causal frontier (int32, read on the device)
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;
  long long dq_bs, dq_rs, dkv_bs, dkv_rs;
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  int B, H, Sq, Sk;
  int causal, off_static;
  int drop_bq, drop_bk;     // the JAX kernels' dropout blocks
  unsigned keep_threshold;  // keep iff hash >= this: uint32(rate·2^32)
  float drop_scale;         // 1/(1 - rate) in f32
  float scale;
};

// leading dimensions in shared memory: multiples of 8 (16-bit) and 4 (f32)
// as wmma requires, padded off a multiple of 128 bytes against bank
// conflicts
template <int D> struct Ld {
  static constexpr int T = D + PAD_H;    // q/k/v/do tiles, 16-bit
  static constexpr int S = BN + PAD_F;   // score tiles, f32
  static constexpr int P = BN + PAD_H;   // probability tiles, 16-bit
  static constexpr int O = D + PAD_F;    // output accumulator/staging, f32
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [r0, r0 + 64) of one head (D contiguous 16-bit elements each,
// row stride `rs`) into a shared tile with leading dimension LD, in 16-byte
// vectors; rows at or past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long rs, int r0, int S) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::T + c) = val;
  }
}

// Write this warp's 16 rows of an f32 staging tile (leading dimension
// Ld<D>::O) to rows [r0 + 16*warp, ...) of one head, times `mul`, in T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long rs,
                                           const float* __restrict__ stage,
                                           int r0, int S, float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    if (r0 + row >= S) break;
    for (int c = lane; c < D; c += 32)
      dst[(long long)(r0 + row) * rs + c] =
          from_float<T>(stage[row * Ld<D>::O + c] * mul);
  }
}

inline int smem_optin(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// --- one (batch, head) and its score elements ------------------------------

struct Head {
  int b, h;
  const float* bias;   // this head's bias plane, or null
  int off;             // causal frontier: row r sees key c iff r + off >= c
  unsigned hash_base;  // seed + (b·H + h)·0x9E3779B9, dropout only
  int dbo_q, dbo_k;
};

__device__ __forceinline__ Head head_of(const FlashArgs& a, int bh) {
  Head hd;
  hd.b = bh / a.H;
  hd.h = bh % a.H;
  hd.bias = a.bias ? a.bias + hd.b * a.bias_sb + hd.h * a.bias_sh : nullptr;
  hd.off = a.causal_off ? *a.causal_off : a.off_static;
  hd.hash_base = a.seed ? (unsigned)*a.seed + (unsigned)bh * 0x9E3779B9u : 0u;
  hd.dbo_q = a.dbo ? a.dbo[0] : 0;
  hd.dbo_k = a.dbo ? a.dbo[1] : 0;
  return hd;
}

// The kernels are compiled twice: OPTS = false for a call with no bias, no
// causal mask and no dropout (BERT without padding), whose per-element work
// stays a scale and a bounds test, and OPTS = true for everything else.

// The bias at key c when it does not vary along rows (bias_sq = 0, as a
// (B, 1, 1, Sk) padding mask), so a loop reads it once a tile; 0 otherwise.
__device__ __forceinline__ float col_bias(const FlashArgs& a, const Head& hd,
                                          int c) {
  return hd.bias && a.bias_sq == 0 && c < a.Sk ? hd.bias[c * a.bias_sk] : 0.f;
}

// s = raw·scale + bias at global (r, c), or -inf where the element is
// masked: a row past Sq, a key past Sk, or a key past the causal frontier.
// `bc` is col_bias(c).
template <bool OPTS>
__device__ __forceinline__ float score(const FlashArgs& a, const Head& hd,
                                       float raw, int r, int c, float bc) {
  if (r >= a.Sq || c >= a.Sk) return -INFINITY;
  if constexpr (!OPTS) {
    return raw * a.scale;
  } else {
    if (a.causal && r + hd.off < c) return -INFINITY;
    float s = raw * a.scale;
    if (hd.bias) s += a.bias_sq ? hd.bias[r * a.bias_sq + c * a.bias_sk] : bc;
    return s;
  }
}

// The softmax-dropout mask of the JAX package (attention.py::_mix_keep):
// a lowbias32 avalanche over (seed, b·H + h, q-block, k-block, row in
// block, column in block), the blocks being the JAX kernels' dropout
// blocks (drop_bq, drop_bk) shifted by the block offsets. uint32
// arithmetic wraps as it does there. The row and column terms are summed
// apart so a loop computes each once.
__device__ __forceinline__ unsigned row_hash(const FlashArgs& a,
                                             const Head& hd, int r) {
  const unsigned iq = (unsigned)(r / a.drop_bq + hd.dbo_q);
  return hd.hash_base + iq * 0x85EBCA6Bu
         + (unsigned)(r % a.drop_bq) * 0x27D4EB2Fu;
}
__device__ __forceinline__ unsigned col_hash(const FlashArgs& a,
                                             const Head& hd, int c) {
  const unsigned ik = (unsigned)(c / a.drop_bk + hd.dbo_k);
  return ik * 0xC2B2AE35u + (unsigned)(c % a.drop_bk) * 0x165667B1u;
}
__device__ __forceinline__ bool keep(const FlashArgs& a, unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= a.keep_threshold;
}

}  // namespace apex_flash
