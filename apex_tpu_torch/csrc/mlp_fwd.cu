// Fused MLP forward for Hopper (sm_90a): y = act(...act(act(x·W0 + b0)·W1
// + b1)...), f32 inside, one cast to x's dtype at the end.
//
// Replaces apex_tpu/ops/mlp.py::_mlp_kernel (the pallas_call in
// _fused_mlp_fwd_impl). x is f32, bf16 or fp16 (n, D0); the weights are
// (Di, Di+1) in one of those dtypes, the biases (Di+1,) in one; the
// activation (none, relu = max(v, 0) keeping NaN, sigmoid = 1/(1 + e^-v))
// follows every layer, the last included. Every product, bias add and
// activation is f32 FMA on the CUDA cores, as the TPU kernel keeps h in f32.
// No TF32 and no bf16 split onto the tensor cores: TF32 keeps 10 bits of
// each operand, and a split rounds every term again, so either moves the
// numbers off the f32 chain that the JAX package's kernel computes and the
// port's checks hold this one to (1e-4 of the plain version on the card);
// that route is left for a change that also states its new tolerance.
//
// Half-operand mode (MlpCall.rnd: 1 = bf16, 2 = fp16). Under amp O1 the JAX
// package's functional patch casts both operands of the kernel body's
// jnp.dot to the policy's half dtype, with the products still summed in
// f32. Here each product's two operands are rounded to that dtype (round
// to nearest even) where they enter the kernel: x as it is loaded, h as it
// is stored into shared memory for the next layer, the weights as they are
// widened from their stage. The FMA loops and their summation order are
// the same in every mode; the bias add, the activation and the last
// layer's output stay f32, rounded once to x's dtype. The mode is a
// template argument, so the rounding costs nothing where it is off.
//
// What bounds it on an H100: operations. At the DLRM bottom MLP (B2048 x
// [13, 512, 256, 128]) the products are 2·n·Σ Di·Di+1 = 698 MFLOP, 10.4 us
// at the 67 TFLOP/s f32 rate, against x, y and the bf16 weights, 0.92 MB
// (0.27 us at 3.35 TB/s). At the budget's edge (B8192 x [1024, 1024,
// 1024], f32) 34.4 GFLOP, 513 us, against 41 MB.
//
// Design. A block of 256 threads owns 16 rows and keeps their activations
// in shared memory as f32 through every layer (two buffers that swap); it
// writes nothing to device memory between layers, and each output row
// comes from one block, with no atomics, so blocks may run in any order.
// - Register tiles. A thread computes 4 rows x TN columns (TN = 4 for a
//   layer wider than 128, 2 up to 128, 1 up to 64, so every thread has
//   work at every width): a warp is 4 row groups x 8 column groups (16
//   rows x 8·TN columns), the 8 warps side by side, and a layer wider than
//   64·TN takes several passes. Per 4 steps of the reduction a thread loads
//   4 float4s of h (rows r, r + 4, r + 8, r + 12: the row stride is 4 mod
//   32 floats, so the four row groups read distinct banks) and 4 x TN
//   weights, for 16·TN FMAs. Each output is summed by one thread in
//   increasing k, so two launches agree bit for bit.
// - Staged weights. The weight columns of a pass are copied from L2 into a
//   ring of two shared-memory stages of 32 KB, 64 rows of the reduction
//   (K) of 16-bit weights or 32 of f32 each, raw in the weights' dtype, by
//   cp.async (16 bytes a copy, zeros past the matrix) where a weight row
//   is a whole number of 16-byte chunks, else by plain loads. The copies
//   run a slice ahead across passes and layers (the weights do not depend
//   on the activations), so a slice's copy runs under the previous
//   slice's FMAs, with one barrier a slice; 16-bit weights are widened to
//   f32 as they are read from shared memory. Fewer, larger stages measured
//   faster than more, smaller ones: the cost is per slice
//   (scripts/torch_kernel_variants.py).
// - Why 16 rows and one block an SM, and no cluster. At n = 2048 the 128
//   blocks fill 128 of the 132 SMs, and every SM does 1/128 of the work
//   whatever the tiling; what a tiling changes is the work an SM issues
//   beside its FMAs and the bytes its shared memory delivers. With 16 rows
//   an SM, a 4 x 4 tile is the largest that keeps 8 warps busy, and it
//   takes 48 bytes of shared-memory delivery (h, then weights) for every
//   32 FMAs of a warp, so the SM's 128 bytes a clock bind before its FMA
//   pipes do: more warps over the same tiles, or a cluster of 2-4 blocks
//   sharing a 16-row tile (each block a share of the columns, written into
//   its peers' shared memory, with smaller tiles and a cluster barrier a
//   layer) cannot lift that. A cluster over 32 or more rows would allow
//   larger tiles but not fit the activations of the widest layers. No
//   cluster was built.
// A layer wider than kMaxLd (with the weight stages, past the 227 KB
// opt-in) runs one launch per layer of mlp_layer over an f32 workspace the
// wrapper allocates: a block computes 16 rows x 256 columns, staging
// 512-wide slices of its rows' input in shared memory and streaming the
// weights from L2. Every layer is still f32, with one cast at the end. Up
// to 32 layers run in one fused launch; more continue in further launches
// from the workspace.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace {

constexpr int kRows = 16;          // rows a block owns
constexpr int kThreads = 256;
constexpr int kMaxLayers = 32;     // layers one fused launch runs
constexpr int kStages = 2;         // weight stages in the ring
constexpr int kCw = 256;           // widest pass: 8 warps x 8 groups x 4
// widest layer (rounded up to 4) the fused kernel holds: two 16-row f32
// activation buffers of a row stride of kMaxLd floats beside the ring of
// f32 weight stages, within the 227 KB opt-in
constexpr int kMaxLd = 1284;
constexpr int kSlice = 512;        // input slice of the per-layer kernel

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Act { kNone = 0, kRelu = 1, kSigmoid = 2 };

struct FusedArgs {
  const void* in;                  // (n, dims[0]) in in_dtype
  void* out;                       // (n, dims[layers]) in out_dtype
  const void* w[kMaxLayers];
  const void* b[kMaxLayers];       // all null without bias
  int dims[kMaxLayers + 1];
  unsigned vec;                    // bit l: W_l's rows are 16-byte chunks
  int layers, n, in_dtype, out_dtype, b_dtype, act, ldp;
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

// an operand rounded to the half dtype of the half-operand mode, back in
// f32: RND 0 none, 1 bf16, 2 fp16
template <int RND>
__device__ __forceinline__ float round_op(float v) {
  if constexpr (RND == 1) return __bfloat162float(__float2bfloat16_rn(v));
  else if constexpr (RND == 2) return __half2float(__float2half_rn(v));
  else return v;
}

// true where widening a TW weight already gives the mode's value
template <typename TW, int RND>
struct Exact {
  static constexpr bool value =
      RND == 0 || (RND == 1 && std::is_same<TW, __nv_bfloat16>::value) ||
      (RND == 2 && std::is_same<TW, __half>::value);
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return v < 0.f ? 0.f : v;   // NaN stays NaN
  if (act == kSigmoid) return 1.f / (1.f + expf(-v));
  return v;
}

// --- the fused kernel -------------------------------------------------------

// Reduction rows of a weight stage: 32 KB a stage in every dtype (64 rows
// of 16-bit weights, 32 of f32), as few stages (and barriers) as the bytes
// allow
template <typename TW>
struct Ring {
  static constexpr int kKs = 128 / (int)sizeof(TW);
};

// TN of a layer of width dout (a pass covers 64·TN columns), as log2
__device__ __forceinline__ int layer_tn_log2(int dout) {
  return dout > 128 ? 2 : dout > 64 ? 1 : 0;
}

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// A weight stage's place in the stream of copies
struct Slice {
  int l, p, s;                     // layer, pass, slice of the pass
};

// Copies a stage: a pass's columns [c0, c0 + 64·tn) of reduction rows
// [k0, k0 + kKs) of W_l (din x dout), raw, row stride kCw elements, zeros
// past the matrix; one cp.async group a call.
template <typename TW>
__device__ __forceinline__ void copy_slice(const FusedArgs& a, Slice sl,
                                           TW* stage) {
  constexpr int kKs = Ring<TW>::kKs;
  const int din = a.dims[sl.l], dout = a.dims[sl.l + 1];
  const int cw_log2 = 6 + layer_tn_log2(dout);    // powers of two: shifts
  const int k0 = sl.s * kKs, c0 = sl.p << cw_log2;
  const TW* W = static_cast<const TW*>(a.w[sl.l]);
  if (a.vec >> sl.l & 1) {
    constexpr int V = 16 / sizeof(TW);
    constexpr int V_LOG2 = V == 8 ? 3 : 2;
    const int row_log2 = cw_log2 - V_LOG2;        // chunks a row
    for (int q = threadIdx.x; q < kKs << row_log2; q += kThreads) {
      const int kk = q >> row_log2, cc = (q & ((1 << row_log2) - 1)) * V;
      const int k = k0 + kk, col = c0 + cc;
      const bool in = k < din && col < dout;
      const TW* src = in ? W + (long long)k * dout + col : W;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          stage + kk * kCw + cc);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst),
                   "l"(src), "r"(in ? 16 : 0));
    }
  } else {
    for (int q = threadIdx.x; q < kKs << cw_log2; q += kThreads) {
      const int kk = q >> cw_log2, cc = q & ((1 << cw_log2) - 1);
      const int k = k0 + kk, col = c0 + cc;
      stage[kk * kCw + cc] =
          k < din && col < dout ? W[(long long)k * dout + col] : TW(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// the slice after sl in (layer, pass, slice) order; false past the last
template <typename TW>
__device__ __forceinline__ bool next_slice(const FusedArgs& a, Slice& sl) {
  constexpr int kKs = Ring<TW>::kKs;
  const int din = a.dims[sl.l], dout = a.dims[sl.l + 1];
  if (++sl.s < (din + kKs - 1) / kKs) return true;
  sl.s = 0;
  const int cw_log2 = 6 + layer_tn_log2(dout);
  if (++sl.p < (dout + (1 << cw_log2) - 1) >> cw_log2) return true;
  sl.p = 0;
  return ++sl.l < a.layers;
}

// TN weights of one reduction row from a stage, widened to f32
template <typename TW, int TN>
__device__ __forceinline__ void load_w_raw(const TW* p, float (&w)[TN]) {
  if constexpr (sizeof(TW) == 4) {
    if constexpr (TN == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (TN == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = to_f32(p[0]);
    }
  } else if constexpr (TN == 1) {
    w[0] = to_f32(p[0]);
  } else {
    unsigned u[TN / 2];
    if constexpr (TN == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x; u[1] = v.y;
    } else {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) {
      if constexpr (std::is_same<TW, __nv_bfloat16>::value) {
        w[2 * i] = __uint_as_float(u[i] << 16);
        w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      } else {
        w[2 * i] = __half2float(__ushort_as_half((unsigned short)(u[i])));
        w[2 * i + 1] =
            __half2float(__ushort_as_half((unsigned short)(u[i] >> 16)));
      }
    }
  }
}

// ... and rounded to the mode's dtype where widening does not already
template <typename TW, int TN, int RND>
__device__ __forceinline__ void load_w(const TW* p, float (&w)[TN]) {
  load_w_raw<TW, TN>(p, w);
  if constexpr (!Exact<TW, RND>::value) {
#pragma unroll
    for (int i = 0; i < TN; ++i) w[i] = round_op<RND>(w[i]);
  }
}

// acc += h[rows][k0 + kk] · stage[kk][cols] for kk < kn (a multiple of 4)
template <typename TW, int TN, bool FULL, int RND>
__device__ __forceinline__ void fma_slice(float (&acc)[4][TN],
                                          const float* h, int ldp,
                                          const TW* wcol, int kn) {
  constexpr int kKs = Ring<TW>::kKs;
#pragma unroll
  for (int kk = 0; kk < (FULL ? kKs : kn); kk += 4) {
    float4 hv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hv[i] = *reinterpret_cast<const float4*>(h + i * 4 * ldp + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float w[TN];
      load_w<TW, TN, RND>(wcol + (kk + u) * kCw, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hk = u == 0 ? hv[i].x : u == 1 ? hv[i].y
                       : u == 2 ? hv[i].z : hv[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(hk, w[j], acc[i][j]);
      }
    }
  }
}

// One layer at TN columns a thread: every pass, every slice of each. A
// slice waits for its own copy, then one barrier (every thread is done
// with the previous slice's stage), then the copy kStages - 1 slices ahead
// goes into that stage, then the FMAs. Returns with `next` and `stage`
// advanced past the layer's slices.
template <typename TW, int TN, int RND>
__device__ void run_layer(const FusedArgs& a, int l, const float* hin,
                          float* hout, TW* ring, Slice& next, bool& more,
                          int& stage, int rows) {
  constexpr int kKs = Ring<TW>::kKs;
  const int din = a.dims[l], dout = a.dims[l + 1];
  const bool last = l == a.layers - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 3, cg = lane >> 2;
  const int col_off = warp * 8 * TN + cg * TN;
  const int slices = (din + kKs - 1) / kKs;
  const int kd = round4(din), rd = round4(dout);
  const float* h = hin + rg * a.ldp;
  for (int c0 = 0; c0 < dout; c0 += 64 * TN) {
    float acc[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < slices; ++s) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
      __syncthreads();
      if (more) more = next_slice<TW>(a, next);
      if (more)
        copy_slice<TW>(a, next,
                       ring + (stage + kStages - 1) % kStages * kKs * kCw);
      else
        asm volatile("cp.async.commit_group;\n" ::);
      const TW* wcol = ring + stage * kKs * kCw + col_off;
      const int kn = min(kKs, kd - s * kKs);
      if (kn == kKs)
        fma_slice<TW, TN, true, RND>(acc, h + s * kKs, a.ldp, wcol, kKs);
      else
        fma_slice<TW, TN, false, RND>(acc, h + s * kKs, a.ldp, wcol, kn);
      stage = (stage + 1) % kStages;
    }
    const int col = c0 + col_off;
    if (col >= rd) continue;
    float bj[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      bj[j] = a.b[l] && col + j < dout ? load_any(a.b[l], a.b_dtype, col + j)
                                       : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 4 * i;
      float v[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        v[j] = col + j < dout ? activate(acc[i][j] + bj[j], a.act) : 0.f;
      if (!last) {
        // the next layer's operand, rounded as it is stored
#pragma unroll
        for (int j = 0; j < TN; ++j) v[j] = round_op<RND>(v[j]);
        float* o = hout + r * a.ldp + col;
        if constexpr (TN == 4)
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        else if constexpr (TN == 2)
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        else
          o[0] = v[0];
      } else if (r < rows) {
        const long long base = ((long long)blockIdx.x * kRows + r) * dout;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (col + j < dout) store_any(a.out, a.out_dtype, base + col + j,
                                        v[j]);
      }
    }
  }
}

template <typename TW, int RND>
__global__ void __launch_bounds__(kThreads, 1) mlp_fused(const FusedArgs a) {
  constexpr int kKs = Ring<TW>::kKs;
  extern __shared__ __align__(16) float smem[];
  float* hin = smem;
  float* hout = smem + kRows * a.ldp;
  TW* ring = reinterpret_cast<TW*>(smem + 2 * kRows * a.ldp);
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, a.n - row0);

  // the first kStages - 1 weight slices go out before x is read
  Slice next{0, 0, 0};
  copy_slice<TW>(a, next, ring);
  bool more = true;
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (more) more = next_slice<TW>(a, next);
    if (more)
      copy_slice<TW>(a, next, ring + i * kKs * kCw);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }
  int stage = 0;
  const int d0 = a.dims[0], w0 = round4(d0);
  for (int i = threadIdx.x; i < kRows * w0; i += kThreads) {
    const int r = i / w0, c = i % w0;
    hin[r * a.ldp + c] = r < rows && c < d0
        ? round_op<RND>(load_any(a.in, a.in_dtype, (row0 + r) * d0 + c))
        : 0.f;
  }
  // (the first slice's barrier orders these stores before any read)
  for (int l = 0; l < a.layers; ++l) {
    switch (layer_tn_log2(a.dims[l + 1])) {
      case 2:
        run_layer<TW, 4, RND>(a, l, hin, hout, ring, next, more, stage,
                              rows);
        break;
      case 1:
        run_layer<TW, 2, RND>(a, l, hin, hout, ring, next, more, stage,
                              rows);
        break;
      default:
        run_layer<TW, 1, RND>(a, l, hin, hout, ring, next, more, stage,
                              rows);
    }
    float* t = hin;
    hin = hout;
    hout = t;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// --- the per-layer kernel (past kMaxLd) -------------------------------------

// acc[r] += Σ_{k < kn} h[r·ld + k] · W[(k0 + k)·dout + j], h 16-byte aligned
// and ld a multiple of 4
template <typename TW, int RND>
__device__ __forceinline__ void dot_rows(float (&acc)[kRows], const float* h,
                                         int ld, const TW* W, int dout,
                                         int j, int k0, int kn) {
  const TW* wj = W + (long long)k0 * dout + j;
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= kn; k += 4) {
    const float w0 = round_op<RND>(to_f32(wj[(long long)k * dout]));
    const float w1 = round_op<RND>(to_f32(wj[(long long)(k + 1) * dout]));
    const float w2 = round_op<RND>(to_f32(wj[(long long)(k + 2) * dout]));
    const float w3 = round_op<RND>(to_f32(wj[(long long)(k + 3) * dout]));
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
    const float w = round_op<RND>(to_f32(wj[(long long)k * dout]));
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h[r * ld + k], w, acc[r]);
  }
}

template <typename TW, int RND>
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
          r < rows ? round_op<RND>(load_any(a.in, a.in_dtype,
                                            (row0 + r) * a.din + k0 + c))
                   : 0.f;
    }
    __syncthreads();
    if (j < a.dout)
      dot_rows<TW, RND>(acc, hs, kSlice, W, a.dout, j, k0, kn);
  }
  if (j >= a.dout) return;
  const float bj = a.b ? load_any(a.b, a.b_dtype, j) : 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < rows)
      store_any(a.out, a.out_dtype, (row0 + r) * a.dout + j,
                activate(acc[r] + bj, a.act));
}

template <typename TW, int RND>
int launch(const void* x, void* y, float* ws, const long long* w,
           const long long* b, const long long* dims, int layers, int n,
           int x_dtype, int b_dtype, int act, cudaStream_t st) {
  long long widest = 0, hidden = 0;
  for (int l = 0; l <= layers; ++l) {
    if (dims[l] <= 0 || dims[l] > INT_MAX / 2)
      return (int)cudaErrorInvalidValue;
    widest = std::max(widest, dims[l]);
    if (l > 0 && l < layers) hidden = std::max(hidden, dims[l]);
  }
  const int ld = (int)((widest + 3) / 4 * 4);
  const bool fused = ld <= kMaxLd;
  const int per_launch = fused ? kMaxLayers : 1;
  if (layers > per_launch && ws == nullptr) return (int)cudaErrorInvalidValue;
  float* buf[2] = {ws, ws ? ws + (long long)n * hidden : nullptr};
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  // the fused kernel's row stride: >= ld and 4 mod 32 floats
  const int ldp = 32 * ((ld - 4 + 31) / 32) + 4;
  const size_t smem = sizeof(float) * 2 * kRows * ldp +
                      sizeof(TW) * kStages * Ring<TW>::kKs * kCw;
  if (fused) {
    static bool opted = false;    // once an instance, for the widest
    if (!opted) {
      const cudaError_t e = cudaFuncSetAttribute(
          mlp_fused<TW, RND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)(sizeof(float) * 2 * kRows * kMaxLd +
                sizeof(TW) * kStages * Ring<TW>::kKs * kCw));
      if (e != cudaSuccess) return (int)e;
      opted = true;
    }
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
        a.w[l] = reinterpret_cast<const void*>(w[l0 + l]);
        a.b[l] = reinterpret_cast<const void*>(b[l0 + l]);
        if ((dims[l0 + l + 1] * (long long)sizeof(TW)) % 16 == 0 &&
            w[l0 + l] % 16 == 0)
          a.vec |= 1u << l;
      }
      for (int l = 0; l <= nl; ++l) a.dims[l] = (int)dims[l0 + l];
      a.layers = nl;
      a.n = n;
      a.in_dtype = in_dt;
      a.out_dtype = out_dt;
      a.b_dtype = b_dtype;
      a.act = act;
      a.ldp = ldp;
      mlp_fused<TW, RND><<<blocks, kThreads, smem, st>>>(a);
    } else {
      LayerArgs a = {in, out, reinterpret_cast<const void*>(w[l0]),
                     reinterpret_cast<const void*>(b[l0]), (int)dims[l0],
                     (int)dims[l0 + 1], n, in_dt, out_dt, b_dtype, act};
      dim3 grid(blocks, (unsigned)((dims[l0 + 1] + kThreads - 1) / kThreads));
      mlp_layer<TW, RND><<<grid, kThreads, 0, st>>>(a);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename TW>
int launch_mode(int rnd, const void* x, void* y, float* ws,
                const long long* w, const long long* b,
                const long long* dims, int layers, int n, int x_dtype,
                int b_dtype, int act, cudaStream_t st) {
  if (rnd == 0)
    return launch<TW, 0>(x, y, ws, w, b, dims, layers, n, x_dtype, b_dtype,
                         act, st);
  if (rnd == kBF16)
    return launch<TW, 1>(x, y, ws, w, b, dims, layers, n, x_dtype, b_dtype,
                         act, st);
  if (rnd == kF16)
    return launch<TW, 2>(x, y, ws, w, b, dims, layers, n, x_dtype, b_dtype,
                         act, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One call's arguments as the wrapper packs them, every field 64 bits:
// x (n, dims[0]) in x_dtype -> y (n, dims[layers]) in x_dtype; ws an f32
// device workspace of 2·n·(widest hidden layer) elements, needed (else 0)
// when the layers take more than one launch (mlp._workspace_cols). Dtypes:
// 0 = f32, 1 = bf16, 2 = fp16 (the weights one dtype, the biases one);
// act: 0 = none, 1 = relu, 2 = sigmoid; rnd: the half-operand mode, 0 =
// off, 1 = bf16, 2 = fp16 (each product's operands rounded to it). The
// struct is followed in memory
// by `layers` weight addresses, `layers` bias addresses (all 0: no bias)
// and the layers + 1 widths, 64 bits each.
struct MlpCall {
  long long x, y, ws, n, layers, x_dtype, w_dtype, b_dtype, act, rnd;
};

// Launches on stream (mlp._launches(dims) launches); returns the CUDA
// error code (0: launched).
extern "C" int apex_mlp_fwd(const MlpCall* k, void* stream) {
  const long long layers = k->layers, n = k->n;
  if (layers <= 0 || n <= 0 || n > INT_MAX || layers > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  const long long* w = reinterpret_cast<const long long*>(k + 1);
  const long long* b = w + layers;
  const long long* dims = b + layers;
  const void* x = reinterpret_cast<const void*>(k->x);
  void* y = reinterpret_cast<void*>(k->y);
  float* ws = reinterpret_cast<float*>(k->ws);
  const int L = (int)layers, N = (int)n, xd = (int)k->x_dtype;
  const int bd = (int)k->b_dtype, act = (int)k->act, rnd = (int)k->rnd;
  cudaStream_t st = (cudaStream_t)stream;
  if (k->w_dtype == kF32)
    return launch_mode<float>(rnd, x, y, ws, w, b, dims, L, N, xd, bd, act,
                              st);
  if (k->w_dtype == kBF16)
    return launch_mode<__nv_bfloat16>(rnd, x, y, ws, w, b, dims, L, N, xd,
                                      bd, act, st);
  if (k->w_dtype == kF16)
    return launch_mode<__half>(rnd, x, y, ws, w, b, dims, L, N, xd, bd, act,
                               st);
  return (int)cudaErrorInvalidValue;
}
