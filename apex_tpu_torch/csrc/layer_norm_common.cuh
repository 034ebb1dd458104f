// Parts shared by the LayerNorm forward (layer_norm_fwd.cu) and backward
// (layer_norm_bwd.cu) kernels for Hopper: dtype conversions, a lane's row
// chunks kept raw in registers (16-byte vectors or single elements), the
// staging of a per-column parameter into shared memory as
// [element of the lane][lane], and warp and block sums in a fixed order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Path { kScalar = 0, kVector = 1, kStaged = 2, kStreamed = 3 };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStaged = 231424;   // bytes of shared memory a block opts in

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float load_param(const void* p, int dt, int i) {
  if (dt == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Element j of a 16-byte chunk, and a 16-byte chunk from CH values, by bit
// operations on its four words (the chunk stays in registers)
__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
template <typename T> __device__ __forceinline__ float elem(const uint4& r,
                                                            int j);
template <> __device__ __forceinline__ float elem<float>(const uint4& r,
                                                         int j) {
  return __uint_as_float(word(r, j));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint4& r, int j) {
  const unsigned w = word(r, j >> 1);
  return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
}
template <> __device__ __forceinline__ float elem<__half>(const uint4& r,
                                                          int j) {
  const unsigned w = word(r, j >> 1);
  return __half2float(__ushort_as_half(
      (unsigned short)(j & 1 ? w >> 16 : w & 0xffffu)));
}
__device__ __forceinline__ unsigned bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned bits16(__half v) {
  return __half_as_ushort(v);
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits16(from_f32<T>(v[2 * i])) |
             bits16(from_f32<T>(v[2 * i + 1])) << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A chunk of CH elements of T, kept raw in registers until used: one
// 16-byte vector (CH = 16 / sizeof(T)) or one element (CH = 1)
template <typename T, int CH>
struct Chunk {
  static_assert(CH * sizeof(T) == 16, "a chunk is 16 bytes");
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    return make_uint4(0, 0, 0, 0);
  }
  static __device__ __forceinline__ float get(const Raw& r, int j) {
    return elem<T>(r, j);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = pack<T>(v);
  }
};

template <typename T>
struct Chunk<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ Raw zero() { return from_f32<T>(0.f); }
  static __device__ __forceinline__ float get(const Raw& r, int) {
    return to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *p = from_f32<T>(v[0]);
  }
};

// A param's values for every lane's elements, staged in shared memory as
// [element of the lane][lane]: stage_load issues a thread's loads into
// registers, stage_store writes them.
template <int CH, int NC>
struct Stage {
  static constexpr int N = CH * NC * 32 / kThreads;   // values a thread

  template <typename P>
  static __device__ __forceinline__ void load_t(const void* p, int chunks,
                                                float (&t)[N]) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int i = idx >> 5;
      const int c = (i / CH) * 32 + (idx & 31);
      t[u] = c < chunks ? to_f32(static_cast<const P*>(p)[c * CH + i % CH])
                        : 0.f;
    }
  }

  static __device__ __forceinline__ void load(const void* p, int dt,
                                              int chunks, float (&t)[N]) {
    if (dt == kBF16)
      load_t<__nv_bfloat16>(p, chunks, t);
    else if (dt == kF16)
      load_t<__half>(p, chunks, t);
    else
      load_t<float>(p, chunks, t);
  }

  static __device__ __forceinline__ void store(const float (&t)[N],
                                               float* out) {
#pragma unroll
    for (int u = 0; u < N; ++u) out[threadIdx.x + u * kThreads] = t[u];
  }
};

// xor butterfly: every lane ends with the same sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum, the warps' sums added in warp order; red holds kWarps
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();              // red is written again by the next sum
  return s;
}

// a lane's chunks of the row at xr (zeros past the row, or for no row)
template <typename T, int CH, int NC>
__device__ __forceinline__ void load_row(typename Chunk<T, CH>::Raw (&v)[NC],
                                         const T* xr, bool on, int chunks,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = k * 32 + lane;
    v[k] = on && c < chunks ? Chunk<T, CH>::load(xr + c * CH)
                            : Chunk<T, CH>::zero();
  }
}

}  // namespace
