// LayerNorm forward for Hopper (sm_90a): y = (x - mean)·rsqrt(var + eps),
// then ·γ + β when affine, over the last dim of (n, h) rows, in x's dtype.
//
// Replaces apex_tpu/ops/layer_norm.py::_ln_fwd_kernel (the pallas_call in
// _ln_forward). The moments are the JAX kernel's (layer_norm.py:52-57):
// centred two-pass in f32, mean = Σx/h, then var = Σ(x - mean)²/h, both
// from the row held in registers (not Welford, not E[x²] - E[x]², which
// lose digits for a row far from zero mean at a small eps).
//
// What bounds it on an H100: bytes. One read of x and one write of y
// (BERT-Large: (8192, 1024) bf16, 33.6 MB, 10.0 us at 3.35 TB/s) against a
// few flops an element. The Triton kernel it replaces ran one 4-warp
// program a row and reloaded γ and β for every row.
//
// Design.
// - ln_fwd_warp: a warp owns a row. Each lane holds E elements of it in
//   registers, as NC chunks of CH elements: CH = 16 / sizeof(T) on the
//   vector path (one 16-byte load or store a chunk: 8 bf16/fp16, 4 f32),
//   CH = 1 on the scalar path (a ragged h, or a row or base not 16-byte
//   aligned). Chunk k·32 + lane of the row belongs to a lane, so a warp's
//   loads are coalesced. The sums are xor-shuffle butterflies, so every
//   lane ends with the same bits and two launches agree bit for bit. The
//   grid is persistent: as many 8-warp blocks as fit an SM, times the SM
//   count (both read once), striding over rows. E is 8, 16, 32 or 64 (h
//   up to 2048; up to 512 for f32 on the scalar path, where ptxas spilled
//   at 32 and 64).
// - γ and β are read once a block, into shared memory as f32, laid out so
//   a lane reads its own elements without bank conflicts. In registers
//   (64 a lane at h = 1024) they cut the blocks an SM, and with every warp
//   reading them at once the kernel ran slower than the Triton one
//   (PERF.md). Their loads go out with the first row's, and the block
//   waits for them only after the first row's moments.
// - ln_fwd_block: a row wider than that takes a 256-thread block, staged in
//   shared memory as T (up to 231424 bytes: h = 115712 at 16 bits, 57856
//   at f32); a wider row is read three times from device memory (sum,
//   squares, output). γ and β are read from the caches each row.
//
// layer_norm_common.cuh holds the parts the backward shares.
#include "layer_norm_common.cuh"

#include <climits>

namespace {

constexpr int kMaxDevices = 64;

struct LnArgs {
  const void* x;
  const void* w;                // null: not affine
  const void* b;
  void* y;
  long long n;
  int h, w_dtype, b_dtype;
  float eps;
};

// The blocks an SM that the launch bounds ask for: on the vector path, as
// many as NC raw 16-byte chunks (4 registers each) and about 56 more
// registers allow; the scalar path asks for one and lets ptxas choose.
template <int CH, int NC>
struct Fit {
  static constexpr int kFit = 65536 / (kThreads * (NC * 4 + 56));
  static constexpr int kBlocks =
      CH == 1 || kFit < 1 ? 1 : kFit > 4 ? 4 : kFit;
};

template <typename T, int CH, int NC>
__global__ void __launch_bounds__(kThreads, Fit<CH, NC>::kBlocks)
ln_fwd_warp(const LnArgs a) {
  using C = Chunk<T, CH>;
  constexpr int E = CH * NC;
  // γ and β of every lane's elements, as [element of the lane][lane]
  __shared__ float sw[E * 32], sb[E * 32];
  const int lane = threadIdx.x & 31;
  const int h = a.h;
  const int chunks = h / CH;    // h % CH == 0 on the vector path
  const bool affine = a.w != nullptr;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);

  // The first row's loads and γ's and β's go out together; the first
  // moments are taken before γ and β are needed, so their wait overlaps.
  typename C::Raw v[NC];
  load_row<T, CH, NC>(v, x + row * h, row < a.n, chunks, lane);
  float tw[Stage<CH, NC>::N], tb[Stage<CH, NC>::N];
  if (affine) {
    Stage<CH, NC>::load(a.w, a.w_dtype, chunks, tw);
    Stage<CH, NC>::load(a.b, a.b_dtype, chunks, tb);
  }
#pragma unroll 1
  for (bool first = true;; first = false) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
#pragma unroll
      for (int j = 0; j < CH; ++j) s += C::get(v[k], j);
    }
    const float mean = warp_sum(s) / (float)h;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (k * 32 + lane < chunks) {
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const float d = C::get(v[k], j) - mean;
          q = fmaf(d, d, q);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)h + a.eps);
    if (first) {            // every thread of the block passes here once
      if (affine) {
        Stage<CH, NC>::store(tw, sw);
        Stage<CH, NC>::store(tb, sb);
      }
      __syncthreads();
    }
    if (row >= a.n) break;
    T* yr = y + row * h;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * 32 + lane;
      if (c >= chunks) continue;
      float o[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int i = (k * CH + j) * 32 + lane;
        const float t = (C::get(v[k], j) - mean) * rstd;
        o[j] = affine ? t * sw[i] + sb[i] : t;
      }
      C::store(yr + c * CH, o);
    }
    row += stride;
    if (row >= a.n) break;
    load_row<T, CH, NC>(v, x + row * h, true, chunks, lane);
  }
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads)
ln_fwd_block(const LnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  T* row_s = reinterpret_cast<T*>(smem);
  const int h = a.h;
  const bool affine = a.w != nullptr;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  for (long long row = blockIdx.x; row < a.n; row += gridDim.x) {
    const T* xr = x + row * h;
    T* yr = y + row * h;
    // a thread reads back only the elements it staged: no barrier needed
    // between the passes beyond block_sum's
    float s = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const T t = xr[i];
      if (STAGED) row_s[i] = t;
      s += to_f32(t);
    }
    const float mean = block_sum(s, red) / (float)h;
    float q = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float d = to_f32(STAGED ? row_s[i] : xr[i]) - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(block_sum(q, red) / (float)h + a.eps);
    for (int i = threadIdx.x; i < h; i += kThreads) {
      float t = (to_f32(STAGED ? row_s[i] : xr[i]) - mean) * rstd;
      if (affine)
        t = t * load_param(a.w, a.w_dtype, i) + load_param(a.b, a.b_dtype, i);
      yr[i] = from_f32<T>(t);
    }
  }
}

// The card's SM count, read once a device.
int sm_count(int* sms) {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < kMaxDevices && cache[dev]) {
    *sms = cache[dev];
    return 0;
  }
  err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err && dev < kMaxDevices) cache[dev] = *sms;
  return err;
}

template <typename T, int CH, int NC>
int launch_warp(const LnArgs& a, cudaStream_t st) {
  static int per_sm = 0;        // blocks an SM, read once an instance
  int err = 0;
  if (!per_sm)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_fwd_warp<T, CH, NC>, kThreads, 0);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const long long want = (a.n + kWarps - 1) / kWarps;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  ln_fwd_warp<T, CH, NC>
      <<<(int)(want < cap ? want : cap), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool STAGED>
int launch_block(const LnArgs& a, cudaStream_t st) {
  size_t smem = 0;
  int err = 0;
  if constexpr (STAGED) {
    smem = (size_t)a.h * sizeof(T);
    if (smem > (size_t)kMaxStaged) return (int)cudaErrorInvalidValue;
    static bool opted = false;   // past 48 KB once an instance
    if (smem > (48 << 10) && !opted) {
      err = (int)cudaFuncSetAttribute(
          ln_fwd_block<T, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxStaged);
      opted = !err;
    }
  }
  int per_sm = 0, sms = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_fwd_block<T, STAGED>, kThreads, smem);
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  ln_fwd_block<T, STAGED><<<(int)(a.n < cap ? a.n : cap), kThreads, smem,
                            st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const LnArgs& a, int path, int epl, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (path == kStaged) return launch_block<T, true>(a, st);
  if (path == kStreamed) return launch_block<T, false>(a, st);
  if (epl * 32 < a.h) return (int)cudaErrorInvalidValue;
  if (path == kVector) {
    if (a.h % V) return (int)cudaErrorInvalidValue;
    switch (epl) {
      case 8: return launch_warp<T, V, 8 / V>(a, st);
      case 16: return launch_warp<T, V, 16 / V>(a, st);
      case 32: return launch_warp<T, V, 32 / V>(a, st);
      case 64: return launch_warp<T, V, 64 / V>(a, st);
    }
  } else if (path == kScalar) {
    switch (epl) {
      case 8: return launch_warp<T, 1, 8>(a, st);
      case 16: return launch_warp<T, 1, 16>(a, st);
      // f32 rows of one element a load past 512 take a block (ptxas
      // spilled these instances)
      case 32:
        if constexpr (sizeof(T) < 4) return launch_warp<T, 1, 32>(a, st);
        break;
      case 64:
        if constexpr (sizeof(T) < 4) return launch_warp<T, 1, 64>(a, st);
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One call's arguments as the wrapper packs them, every field 64 bits: y
// (n, h) = LayerNorm(x (n, h)) in x's dtype (0 f32, 1 bf16, 2 fp16); w and
// b (h,) in their own dtypes, both 0 for no affine. path: 0 scalar warp,
// 1 vector warp (h % (16 / itemsize) == 0, x and y 16-byte aligned), with
// epl elements a lane (8, 16, 32 or 64; epl·32 >= h); 2 a block a row
// staged in shared memory, 3 a block a row read from device memory
// (layer_norm._ln_plan).
struct LnCall {
  long long x, w, b, y, n, h, x_dtype, w_dtype, b_dtype, path, epl;
  double eps;
};

// Launches on stream; returns the CUDA error code (0: launched).
extern "C" int apex_ln_fwd(const LnCall* k, void* stream) {
  if (k->n <= 0 || k->h <= 0 || k->h > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const LnArgs a{reinterpret_cast<const void*>(k->x),
                 reinterpret_cast<const void*>(k->w),
                 reinterpret_cast<const void*>(k->b),
                 reinterpret_cast<void*>(k->y), k->n, (int)k->h,
                 (int)k->w_dtype, (int)k->b_dtype, (float)k->eps};
  const int path = (int)k->path, epl = (int)k->epl;
  cudaStream_t st = (cudaStream_t)stream;
  if (k->x_dtype == kBF16) return dispatch<__nv_bfloat16>(a, path, epl, st);
  if (k->x_dtype == kF16) return dispatch<__half>(a, path, epl, st);
  if (k->x_dtype == kF32) return dispatch<float>(a, path, epl, st);
  return (int)cudaErrorInvalidValue;
}
