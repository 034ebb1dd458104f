// Fused MLP forward for Hopper (sm_90a): y = act(...act(act(x·W0 + b0)·W1
// + b1)...), f32 inside, one cast to x's dtype at the end.
//
// Replaces apex_tpu/ops/mlp.py::_mlp_kernel (the pallas_call in
// _fused_mlp_fwd_impl). x is f32, bf16 or fp16 (n, D0); the weights are
// (Di, Di+1) in one of those dtypes, the biases (Di+1,) in one; the
// activation (none, relu = max(v, 0) keeping NaN, sigmoid = 1/(1 + e^-v))
// follows every layer, the last included. Every product, bias add and
// activation is f32 FMA on the CUDA cores, as the TPU kernel keeps h in f32
// (no TF32, no bf16 split: the numbers stay those of the JAX interpret-mode
// kernel up to the order of the sums).
//
// What bounds it on an H100: operations. At the DLRM bottom MLP (B2048 x
// [13, 512, 256, 128]) the products are 2·n·Σ Di·Di+1 = 698 MFLOP, 10.4 us
// at the 67 TFLOP/s f32 rate, against x, y and the bf16 weights, 0.92 MB
// (0.27 us at 3.35 TB/s). At the budget's edge (B8192 x [1024, 1024,
// 1024], f32) 34.4 GFLOP, 513 us, against 41 MB.
//
// Design (the simple first kernel). The TPU kernel keeps every weight (up
// to 8 MiB) in VMEM; a block here has at most 227 KB of shared memory, and
// the 50 MB L2 holds the weights instead. One block of 256 threads owns 16
// rows and keeps their activations in shared memory as f32, in two buffers
// that swap between layers; it streams each weight matrix from L2, a
// thread taking output columns j, tid + 256, ... and keeping that column's
// 16 row sums in registers: per 4 steps of the reduction it loads 4
// weights (neighbouring threads, neighbouring columns: coalesced) and 16
// float4s of h (one address for the warp: a broadcast) for 64 FMAs. A
// __syncthreads() separates the layers; nothing goes to device memory
// between them. Each output row is written by one block, with no atomics,
// so blocks may run in any order. Up to 32 layers run in one launch; more
// layers continue in further launches from an f32 workspace.
//
// A layer wider than 1816 (two 16-row f32 buffers past the 227 KB opt-in)
// runs one launch per layer of mlp_layer over an f32 workspace the wrapper
// allocates: a block computes 16 rows x 256 columns, staging 512-wide
// slices of its rows' input in shared memory. Every layer is still f32,
// with one cast at the end.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kRows = 16;          // rows a block owns
constexpr int kThreads = 256;
constexpr int kMaxLayers = 32;     // layers one fused launch runs
constexpr int kMaxLd = 1816;       // widest layer the fused kernel holds
constexpr int kSlice = 512;        // input slice of the per-layer kernel

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Act { kNone = 0, kRelu = 1, kSigmoid = 2 };

struct FusedArgs {
  const void* in;                  // (n, dims[0]) in in_dtype
  void* out;                       // (n, dims[layers]) in out_dtype
  const void* w[kMaxLayers];
  const void* b[kMaxLayers];       // all null without bias
  int dims[kMaxLayers + 1];
  int layers, n, in_dtype, out_dtype, b_dtype, act, ld;
};

struct LayerArgs {
  const void* in;
  void* out;
  const void* w;
  const void* b;
  int din, dout, n, in_dtype, out_dtype, b_dtype, act;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ float load_any(const void* p, int dt,
                                          long long i) {
  if (dt == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[i]);
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

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return v < 0.f ? 0.f : v;   // NaN stays NaN
  if (act == kSigmoid) return 1.f / (1.f + expf(-v));
  return v;
}

// acc[r] += Σ_{k < kn} h[r·ld + k] · W[(k0 + k)·dout + j], h 16-byte aligned
// and ld a multiple of 4
template <typename TW>
__device__ __forceinline__ void dot_rows(float (&acc)[kRows], const float* h,
                                         int ld, const TW* W, int dout,
                                         int j, int k0, int kn) {
  const TW* wj = W + (long long)k0 * dout + j;
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= kn; k += 4) {
    const float w0 = to_f32(wj[(long long)k * dout]);
    const float w1 = to_f32(wj[(long long)(k + 1) * dout]);
    const float w2 = to_f32(wj[(long long)(k + 2) * dout]);
    const float w3 = to_f32(wj[(long long)(k + 3) * dout]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(h + r * ld + k);
      acc[r] = fmaf(hv.x, w0, acc[r]);
      acc[r] = fmaf(hv.y, w1, acc[r]);
      acc[r] = fmaf(hv.z, w2, acc[r]);
      acc[r] = fmaf(hv.w, w3, acc[r]);
    }
  }
  for (; k < kn; ++k) {
    const float w = to_f32(wj[(long long)k * dout]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h[r * ld + k], w, acc[r]);
  }
}

template <typename TW>
__global__ void __launch_bounds__(kThreads) mlp_fused(const FusedArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* hin = smem;
  float* hout = smem + kRows * a.ld;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, a.n - row0);

  const int d0 = a.dims[0];
  for (int i = threadIdx.x; i < kRows * d0; i += kThreads) {
    const int r = i / d0, c = i % d0;
    hin[r * a.ld + c] =
        r < rows ? load_any(a.in, a.in_dtype, (row0 + r) * d0 + c) : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < a.layers; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1];
    const TW* W = static_cast<const TW*>(a.w[l]);
    const bool last = l == a.layers - 1;
    for (int j = threadIdx.x; j < dout; j += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      dot_rows<TW>(acc, hin, a.ld, W, dout, j, 0, din);
      const float bj = a.b[l] ? load_any(a.b[l], a.b_dtype, j) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = activate(acc[r] + bj, a.act);
        if (!last)
          hout[r * a.ld + j] = v;
        else if (r < rows)
          store_any(a.out, a.out_dtype, (row0 + r) * dout + j, v);
      }
    }
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
  }
}

template <typename TW>
__global__ void __launch_bounds__(kThreads) mlp_layer(const LayerArgs a) {
  __shared__ __align__(16) float hs[kRows * kSlice];
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, a.n - row0);
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const TW* W = static_cast<const TW*>(a.w);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < a.din; k0 += kSlice) {
    const int kn = min(kSlice, a.din - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kn; i += kThreads) {
      const int r = i / kn, c = i % kn;
      hs[r * kSlice + c] =
          r < rows ? load_any(a.in, a.in_dtype,
                              (row0 + r) * a.din + k0 + c) : 0.f;
    }
    __syncthreads();
    if (j < a.dout) dot_rows<TW>(acc, hs, kSlice, W, a.dout, j, k0, kn);
  }
  if (j >= a.dout) return;
  const float bj = a.b ? load_any(a.b, a.b_dtype, j) : 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < rows)
      store_any(a.out, a.out_dtype, (row0 + r) * a.dout + j,
                activate(acc[r] + bj, a.act));
}

template <typename TW>
int launch(const void* x, void* y, float* ws, const void* const* w,
           const void* const* b, const int* dims, int layers, int n,
           int x_dtype, int b_dtype, int act, cudaStream_t st,
           int* launches) {
  int widest = 0, hidden = 0;
  for (int l = 0; l <= layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    widest = std::max(widest, dims[l]);
    if (l > 0 && l < layers) hidden = std::max(hidden, dims[l]);
  }
  const int ld = (widest + 3) / 4 * 4;
  const bool fused = ld <= kMaxLd;
  const int per_launch = fused ? kMaxLayers : 1;
  if (layers > per_launch && ws == nullptr) return (int)cudaErrorInvalidValue;
  float* buf[2] = {ws, ws ? ws + (long long)n * hidden : nullptr};
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  if (fused) {
    const size_t smem = sizeof(float) * 2 * kRows * ld;
    cudaError_t e = cudaFuncSetAttribute(
        mlp_fused<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  for (int l0 = 0, i = 0; l0 < layers; l0 += per_launch, ++i) {
    const int nl = std::min(per_launch, layers - l0);
    const bool first = l0 == 0, last = l0 + nl == layers;
    const void* in = first ? x : buf[(i + 1) % 2];
    void* out = last ? y : buf[i % 2];
    const int in_dt = first ? x_dtype : kF32, out_dt = last ? x_dtype : kF32;
    if (fused) {
      FusedArgs a = {};
      a.in = in;
      a.out = out;
      for (int l = 0; l < nl; ++l) {
        a.w[l] = w[l0 + l];
        a.b[l] = b ? b[l0 + l] : nullptr;
      }
      for (int l = 0; l <= nl; ++l) a.dims[l] = dims[l0 + l];
      a.layers = nl;
      a.n = n;
      a.in_dtype = in_dt;
      a.out_dtype = out_dt;
      a.b_dtype = b_dtype;
      a.act = act;
      a.ld = ld;
      mlp_fused<TW><<<blocks, kThreads, sizeof(float) * 2 * kRows * ld,
                      st>>>(a);
    } else {
      LayerArgs a = {in, out, w[l0], b ? b[l0] : nullptr, dims[l0],
                     dims[l0 + 1], n, in_dt, out_dt, b_dtype, act};
      dim3 grid(blocks, (unsigned)((dims[l0 + 1] + kThreads - 1) / kThreads));
      mlp_layer<TW><<<grid, kThreads, 0, st>>>(a);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  return 0;
}

}  // namespace

// x (n, dims[0]) in x_dtype -> y (n, dims[layers]) in x_dtype. w, b: host
// arrays of `layers` device pointers (b null: no bias); ws: an f32 device
// workspace of 2·n·(widest hidden layer) elements, needed (else null) when
// the layers take more than one launch. Dtypes: 0 = f32, 1 = bf16, 2 =
// fp16; act: 0 = none, 1 = relu, 2 = sigmoid. Returns a cudaError_t (0 =
// launched) and adds the number of launches to *launches.
extern "C" int apex_mlp_fwd(const void* x, void* y, float* ws,
                            const void* const* w, const void* const* b,
                            const int* dims, int layers, int n, int x_dtype,
                            int w_dtype, int b_dtype, int act, void* stream,
                            int* launches) {
  cudaStream_t st = (cudaStream_t)stream;
  if (layers <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (w_dtype == kF32)
    return launch<float>(x, y, ws, w, b, dims, layers, n, x_dtype, b_dtype,
                         act, st, launches);
  if (w_dtype == kBF16)
    return launch<__nv_bfloat16>(x, y, ws, w, b, dims, layers, n, x_dtype,
                                 b_dtype, act, st, launches);
  if (w_dtype == kF16)
    return launch<__half>(x, y, ws, w, b, dims, layers, n, x_dtype, b_dtype,
                          act, st, launches);
  return (int)cudaErrorInvalidValue;
}
