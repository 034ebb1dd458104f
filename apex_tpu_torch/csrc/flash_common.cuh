// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): tile shapes, shared-memory leading dimensions,
// dtype conversion, tile loads and warp reductions.
//
// Layout: q, k, v, do, o and the gradients are (B, S, H, D) tensors whose
// head rows are D contiguous elements; the kernels take each tensor's
// batch and row strides (elements), so q/k/v may be views of one packed
// (B, S, 3·H·D) projection. lse and delta are f32 (B·H, S).
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

}  // namespace apex_flash
