// BatchNorm backward channel sums for Hopper (sm_90a): per channel Σg and
// Σg·x̂ over channels-last (m, c) rows, x̂ = (x - mean)·invstd, with g masked
// by the unit's ReLU: "plain" (no mask), "relu" (x̂·γ + β > 0) or "addrelu"
// (z > 0, writing dr = mask ⊙ g in r's dtype for the residual branch).
//
// Replaces apex_tpu/ops/bn_act.py::_sums_kernel (pass 1 of _bwd_pallas).
// The TPU kernel adds each row block into one (8, c) output block across
// its in-order grid. Hopper blocks run in no order, so here every block
// writes one (2, c) partial of its own rows, and the last block to finish
// adds the partials in block order: no float atomics, and the same plan
// gives the same bits on every launch.
//
// What bounds it on an H100: bytes. One read of x and g (and z, and one
// write of dr at a join) against ~5 flops an element; the ResNet-50 stem
// (3211264 x 64 bf16, two operands) is 822 MB, 245 us at 3.35 TB/s. The
// Triton kernel it replaces reached 72% of that: one (64 x 64) tile of
// loads in flight a program, then a second launch (torch.sum) to add the
// partials.
//
// Design.
// - A thread holds V channels: one 16-byte load of each operand (8 bf16 or
//   fp16, 4 f32) on the vector path, where x, g, z and dr share a dtype, c
//   is a multiple of V and the bases are 16-byte aligned; V = 1, with each
//   operand's dtype read at run time, on the scalar path. tpr threads (a
//   power of two <= 32) cover a channel tile of tpr·V channels, so a
//   512-thread block covers 512 / tpr rows a load: 64 rows at c = 64
//   bf16, two 256-channel slices of rows at c >= 256.
// - One block an SM, persistent over its run of rows. A thread loads
//   kUnroll rows of each operand before it uses any (4 16-byte loads an
//   operand in flight: 64 KB of x and g an SM), keeping Σg and Σg·x̂ in f32
//   registers. One block an SM also halves the partials stage 2 adds,
//   against two 256-thread blocks an SM.
// - The block adds its threads' sums with xor shuffles across the lanes
//   of a warp that hold the same channels, then across its warps in warp
//   order through shared memory, and writes its (2, tile) partial.
// - The plan (tpr, tiles, rows a block, row blocks) is computed by the
//   wrapper from (m, c, SM count) alone (bn_act._bn_sums_plan), so the
//   order of every sum is fixed.
// - Stage 2 in the same launch: after __threadfence(), each block takes a
//   ticket from an integer counter of its channel tile; the block that
//   draws the last one adds the tile's partials in row-block order, writes
//   the (2, c) result and sets the counter back to 0 for the next launch.
// - x̂ and the "relu" mask x̂·γ + β are formed with __fsub_rn, __fmul_rn and
//   __fadd_rn: nvcc would contract a·b + c into one FMA, and the mask (and
//   so dr) must equal the plain PyTorch version's bit for bit.
// - fp8 residuals (the JAX package's _Cfg.fp8): x arrives as x̂ itself in
//   e4m3 (dtype code 3) with the xhat flag, and is used as it is, with no
//   centring. On the vector path its loads are V bytes (Fp8Vec) beside g's
//   16: 3 bytes an element at a bf16 unit, against 4 for x and g.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2, kE4M3 = 3 };
enum Mode { kPlain = 0, kRelu = 1, kAddRelu = 2 };

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;        // rows of each operand a thread loads at once
constexpr int kMaxTile = 256;     // channels of a tile: 32 threads x 8
constexpr int kBatch = 32;        // partials of a sum stage 2 loads at once

__device__ __forceinline__ float load_any(const void* p, int dt, long long i) {
  if (dt == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  if (dt == kE4M3)
    return static_cast<float>(static_cast<const __nv_fp8_e4m3*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, int dt, long long i,
                                          float v) {
  if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if (dt == kF16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

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

// 16 bytes of T: one load or store of V channels, kept raw until used
template <typename T>
struct Vec16 {
  static constexpr int V = 16 / sizeof(T);
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const void* p, int,
                                             long long off) {
    return __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(p) +
                                                off));
  }
  static __device__ __forceinline__ float get(const Raw& r, int j) {
    return to_f32(reinterpret_cast<const T*>(&r)[j]);
  }
  static __device__ __forceinline__ void store(void* p, int, long long off,
                                               const float* v) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(static_cast<T*>(p) + off) = raw;
  }
};

// N e4m3 values (8 bytes beside a 16-bit g, 4 beside an f32 g): the x̂
// operand of the fp8 path, read only
template <int N>
struct Fp8Vec {
  static constexpr int V = N;
  using Raw = typename std::conditional<N == 8, uint2, unsigned int>::type;
  static __device__ __forceinline__ Raw load(const void* p, int,
                                             long long off) {
    return __ldg(reinterpret_cast<const Raw*>(
        static_cast<const __nv_fp8_e4m3*>(p) + off));
  }
  static __device__ __forceinline__ float get(const Raw& r, int j) {
    return static_cast<float>(reinterpret_cast<const __nv_fp8_e4m3*>(&r)[j]);
  }
};

// one channel of any dtype, read at run time
struct Scalar {
  static constexpr int V = 1;
  using Raw = float;
  static __device__ __forceinline__ Raw load(const void* p, int dt,
                                             long long off) {
    return load_any(p, dt, off);
  }
  static __device__ __forceinline__ float get(const Raw& r, int) { return r; }
  static __device__ __forceinline__ void store(void* p, int dt, long long off,
                                               const float* v) {
    store_any(p, dt, off, v[0]);
  }
};

struct SumsArgs {
  const void* x;
  const void* g;
  const void* z;                // "addrelu" only
  const void* scale;            // "relu" only
  const void* bias;
  const float* mean;
  const float* invstd;
  float* part;                  // (row_blocks, 2, c) partials
  int* counters;                // (tiles,), 0 between launches
  float* out;                   // (2, c): Σg, Σg·x̂
  void* dr;                     // "addrelu" only
  long long m, rows;            // rows a block (the last takes the rest)
  int c, row_blocks, tpr_log2;
  int x_dt, g_dt, z_dt, r_dt, s_dt, b_dt;
};

// L loads x (or, with XHAT, the e4m3 x̂), G loads g and z and stores dr
template <typename L, typename G, int MODE, bool XHAT>
__global__ void __launch_bounds__(kThreads, 1) bn_sums(const SumsArgs a) {
  static_assert(L::V == G::V, "x and g loads cover the same channels");
  constexpr int V = G::V;
  __shared__ float red[kWarps][2][kMaxTile];
  __shared__ int last;

  const int tpr = 1 << a.tpr_log2;
  const int rpi = kThreads >> a.tpr_log2;     // rows a load of the block
  const int lc = threadIdx.x & (tpr - 1);     // chunk of the tile
  const int c0 = (blockIdx.y * tpr + lc) * V; // this thread's first channel
  const bool on = c0 < a.c;   // the vector path has c % V == 0: all V or none
  const long long c = a.c;

  float mu[V], is[V], sc[V], bi[V], sg[V], sgx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = (on && !XHAT) ? a.mean[c0 + j] : 0.f;
    is[j] = (on && !XHAT) ? a.invstd[c0 + j] : 0.f;
    sc[j] = (MODE == kRelu && on) ? load_any(a.scale, a.s_dt, c0 + j) : 0.f;
    bi[j] = (MODE == kRelu && on) ? load_any(a.bias, a.b_dt, c0 + j) : 0.f;
    sg[j] = sgx[j] = 0.f;
  }

  const long long r_begin = (long long)blockIdx.x * a.rows;
  const long long r_end = min(a.m, r_begin + a.rows);
  const long long step = (long long)rpi * kUnroll;
  for (long long r0 = r_begin + (threadIdx.x >> a.tpr_log2); r0 < r_end;
       r0 += step) {
    typename L::Raw rx[kUnroll];
    typename G::Raw rg[kUnroll], rz[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + (long long)u * rpi;
      if (on && r < r_end) {
        const long long off = r * c + c0;
        rx[u] = L::load(a.x, a.x_dt, off);
        rg[u] = G::load(a.g, a.g_dt, off);
        if (MODE == kAddRelu) rz[u] = G::load(a.z, a.z_dt, off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + (long long)u * rpi;
      if (!(on && r < r_end)) continue;
      float d[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh =
            XHAT ? L::get(rx[u], j)
                 : __fmul_rn(__fsub_rn(L::get(rx[u], j), mu[j]), is[j]);
        float gv = G::get(rg[u], j);
        if (MODE == kRelu)
          gv = __fadd_rn(__fmul_rn(xh, sc[j]), bi[j]) > 0.f ? gv : 0.f;
        if (MODE == kAddRelu) gv = G::get(rz[u], j) > 0.f ? gv : 0.f;
        d[j] = gv;
        sg[j] += gv;
        sgx[j] = __fmaf_rn(gv, xh, sgx[j]);
      }
      if (MODE == kAddRelu) G::store(a.dr, a.r_dt, r * c + c0, d);
    }
  }

  // lanes of a warp that hold the same channels differ in the bits >= tpr
  for (int o = tpr; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sg[j] += __shfl_xor_sync(0xffffffffu, sg[j], o);
      sgx[j] += __shfl_xor_sync(0xffffffffu, sgx[j], o);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) < tpr) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[warp][0][lc * V + j] = sg[j];
      red[warp][1][lc * V + j] = sgx[j];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;                  // channel t of the tile
  const long long ch = (long long)blockIdx.y * tpr * V + t;
  const bool mine = t < tpr * V && ch < c;
  if (mine) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s0 += red[w][0][t];
      s1 += red[w][1][t];
    }
    float* p = a.part + (long long)blockIdx.x * 2 * c;
    p[ch] = s0;
    p[c + ch] = s1;
  }

  // stage 2: the last block of this channel tile adds the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&a.counters[blockIdx.y], 1) == a.row_blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (mine) {
    // in row-block order; kBatch partials of each sum loaded at once
    float s0 = 0.f, s1 = 0.f;
    for (int b0 = 0; b0 < a.row_blocks; b0 += kBatch) {
      float p0[kBatch], p1[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float* p = a.part + (long long)(b0 + k) * 2 * c;
        const bool in = b0 + k < a.row_blocks;
        p0[k] = in ? __ldcg(p + ch) : 0.f;
        p1[k] = in ? __ldcg(p + c + ch) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (b0 + k < a.row_blocks) {
          s0 += p0[k];
          s1 += p1[k];
        }
      }
    }
    a.out[ch] = s0;
    a.out[c + ch] = s1;
  }
  if (threadIdx.x == 0) a.counters[blockIdx.y] = 0;
}

template <typename L, typename G, bool XHAT>
int launch(const SumsArgs& a, int mode, int tiles, cudaStream_t st) {
  const dim3 grid(a.row_blocks, tiles);
  if (mode == kPlain)
    bn_sums<L, G, kPlain, XHAT><<<grid, kThreads, 0, st>>>(a);
  else if (mode == kRelu)
    bn_sums<L, G, kRelu, XHAT><<<grid, kThreads, 0, st>>>(a);
  else if (mode == kAddRelu)
    bn_sums<L, G, kAddRelu, XHAT><<<grid, kThreads, 0, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// One call's arguments as the wrapper packs them, every field 64 bits:
// the operands' addresses (z and dr 0 outside "addrelu"), the shape, the
// plan (tpr_log2, tiles, rows a block, row_blocks: bn_act._bn_sums_plan),
// the dtype codes (0 f32, 1 bf16, 2 fp16, 3 e4m3: x only, with xhat) of x,
// g, z, dr, scale and bias, two bits each from bit 0, the mode (0 plain,
// 1 relu, 2 addrelu), vector (g, z and dr of one dtype, c % V == 0 for
// V = 16 / g's itemsize, their bases 16-byte aligned, and x of g's dtype
// and 16-byte aligned, or with xhat V-byte aligned) and xhat (x is x̂ in
// e4m3, not centred). part holds row_blocks x 2 x c floats and counters
// `tiles` ints, all 0.
struct SumsCall {
  long long x, g, z, scale, bias, mean, invstd, part, counters, out, dr;
  long long m, c, rows, row_blocks, tpr_log2, tiles, dtypes, mode, vector;
  long long xhat;
};

// Channel sums of (m, c) rows into out (2, c) f32 (and dr at "addrelu").
// Launches on stream; returns the CUDA error code (0: launched).
extern "C" int apex_bn_sums(const SumsCall* k, void* stream) {
  const long long m = k->m, c = k->c, rows = k->rows;
  const long long blocks = k->row_blocks, tiles = k->tiles;
  if (m <= 0 || c <= 0 || c > INT_MAX || rows <= 0 || blocks <= 0 ||
      blocks > INT_MAX || tiles <= 0 || tiles > 65535 || k->tpr_log2 < 0 ||
      k->tpr_log2 > 5 || (blocks - 1) * rows >= m || blocks * rows < m)
    return (int)cudaErrorInvalidValue;
  const int d = (int)k->dtypes;
  const SumsArgs a{
      reinterpret_cast<const void*>(k->x), reinterpret_cast<const void*>(k->g),
      reinterpret_cast<const void*>(k->z),
      reinterpret_cast<const void*>(k->scale),
      reinterpret_cast<const void*>(k->bias),
      reinterpret_cast<const float*>(k->mean),
      reinterpret_cast<const float*>(k->invstd),
      reinterpret_cast<float*>(k->part), reinterpret_cast<int*>(k->counters),
      reinterpret_cast<float*>(k->out), reinterpret_cast<void*>(k->dr),
      m, rows, (int)c, (int)blocks, (int)k->tpr_log2,
      d & 3, (d >> 2) & 3, (d >> 4) & 3, (d >> 6) & 3, (d >> 8) & 3,
      (d >> 10) & 3};
  const int mode = (int)k->mode;
  const bool xhat = k->xhat != 0;
  cudaStream_t st = (cudaStream_t)stream;
  // an e4m3 operand is x̂, and only x may be one
  if (xhat != (a.x_dt == kE4M3) || a.g_dt == kE4M3 || a.s_dt == kE4M3 ||
      a.b_dt == kE4M3 ||
      (mode == kAddRelu && (a.z_dt == kE4M3 || a.r_dt == kE4M3)))
    return (int)cudaErrorInvalidValue;
  if (!k->vector) {
    if ((tiles << k->tpr_log2) < c) return (int)cudaErrorInvalidValue;
    return xhat ? launch<Scalar, Scalar, true>(a, mode, (int)tiles, st)
                : launch<Scalar, Scalar, false>(a, mode, (int)tiles, st);
  }
  const int v = a.g_dt == kF32 ? 4 : 8;
  if (c % v || (tiles << k->tpr_log2) * v < c ||
      (!xhat && a.x_dt != a.g_dt))
    return (int)cudaErrorInvalidValue;
  if (a.g_dt == kBF16)
    return xhat ? launch<Fp8Vec<8>, Vec16<__nv_bfloat16>, true>(
                      a, mode, (int)tiles, st)
                : launch<Vec16<__nv_bfloat16>, Vec16<__nv_bfloat16>, false>(
                      a, mode, (int)tiles, st);
  if (a.g_dt == kF16)
    return xhat ? launch<Fp8Vec<8>, Vec16<__half>, true>(a, mode, (int)tiles,
                                                          st)
                : launch<Vec16<__half>, Vec16<__half>, false>(
                      a, mode, (int)tiles, st);
  if (a.g_dt == kF32)
    return xhat ? launch<Fp8Vec<4>, Vec16<float>, true>(a, mode, (int)tiles,
                                                         st)
                : launch<Vec16<float>, Vec16<float>, false>(
                      a, mode, (int)tiles, st);
  return (int)cudaErrorInvalidValue;
}
