// Flash attention for Hopper (sm_90a) on the CUDA cores: the forward and a
// two-kernel backward for every case the wgmma kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu) refuse: f32 q, k, v, and any head dim 1 <= D <= 256
// in f32, bf16 or fp16.
//
// Replaces, for those operands, apex_tpu/ops/attention.py::_fwd_kernel_nl
// and _fwd_kernel (the forward), _bwd_fused_kernel_nl, _bwd_dq_kernel_nl /
// _bwd_dkv_kernel_nl and _bwd_dq_kernel / _bwd_dkv_kernel (the backward).
// The JAX kernels pad D up to whole 128-lane rows and take f32; these
// kernels pad D up to DP in {64, 128, 256} in shared memory (zero-filled
// columns, masked loads and stores) and take the element type as a
// template parameter. They compute what the wgmma kernels compute, with
// the same FlashArgs (flash_common.cuh): bias with every broadcast through
// its four strides, causal at a static or device-read frontier, softmax
// dropout whose keep mask is the JAX package's hash of (seed, b·H + h,
// q-block, k-block, row, col) over the caller's dropout blocks
// (drop_bq, drop_bk) shifted by dbo, whatever this kernel's own tiles are,
// and the lse out (forward) and in (backward):
//   forward:  o = (P̃ cast to v's dtype)·V / l,  lse = m + log l
//   backward: dV = P̃ᵀ·dO,  dS = P ∘ (dP̃ − delta) cast to q's dtype,
//             dK = dSᵀ·Q·scale,  dQ = dS·K·scale
// with P = exp(s − m) (forward, online) or exp(s − lse) (backward), P̃ and
// dP̃ the kept elements times 1/(1 − rate), softmax and sums in f32.
//
// Arithmetic: every product is FFMA on f32 values in shared memory (the
// 16-bit inputs converted on load, which is exact), so at f32 the
// products are true f32, as the JAX kernels' f32 dots; exponentials and
// logarithms are expf/logf. What bounds it on an H100: operations, at the
// f32 rate (67 TFLOP/s, no tensor cores) for every dtype; at bf16/fp16 the
// bound of the same work is the tensor-core rate, which this kernel does
// not reach (a wgmma version with padded D is later work).
//
// Design: one warpgroup (128 threads) a block, a tile of BQ query rows
// (forward, dQ) or BK keys (dK/dV) of one (batch, head) a block. Tiles are
// f32 in shared memory with rows padded to DP + 1 floats, so the threads
// of a warp reading 16 different rows at one depth hit 16 banks. Products
// run on an 8 x 16 thread grid: a thread owns rows tr + 8i and columns
// tc + 16j of each output tile, and the 16 threads of a row group sit in
// one half-warp, so row reductions are four shuffles. Determinism: no
// atomics; dQ and dK/dV come from two kernels that each recompute s, dP
// and the keep mask, and every sum runs in an order fixed by the shape,
// so the results repeat bit for bit. Tiles wholly past the causal
// frontier are skipped (they add exact zeros).
#include "flash_common.cuh"

using namespace apex_flash;

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTR = 8;         // thread rows of the product grid
constexpr int kTC = 16;        // thread columns (a half-warp)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back, as the plain version's .to(dtype).float()
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Tiles of each kernel by padded head dim DP. Registers a thread: the
// forward's o and the dQ accumulator are (BQ/8)·(DP/16) (32 or 64), dK
// and dV (BK/8)·(DP/16) each (32); shared memory stays under 140 KB.
template <int DP> struct Tiles {
  static constexpr int LD = DP + 1;                 // floats a tile row
  static constexpr int BQ = DP == 256 ? 32 : 64;    // fwd / dQ rows
  static constexpr int BK = DP == 64 ? 64 : 32;     // fwd / dQ keys
  static constexpr int KBK = DP == 256 ? 16 : (DP == 128 ? 32 : 64);
  static constexpr int KBQ = 32;                    // dK/dV q rows a tile
  static constexpr size_t fwd_bytes =
      sizeof(float) * (size_t)((BQ + 2 * BK) * LD + BQ * (BK + 1));
  static constexpr size_t dq_bytes =
      sizeof(float) * (size_t)((2 * BQ + 2 * BK) * LD + BQ * (BK + 1));
  static constexpr size_t dkv_bytes =
      sizeof(float) * (size_t)((2 * KBK + 2 * KBQ) * LD + 2 * KBQ * (KBK + 1)
                               + 2 * KBQ);
};

// rows [row0, row0 + ROWS) of a (B, S, H, D) tensor's head plane `base`
// (row stride rs) into dst (ROWS x DP floats, row stride LD); rows past S
// and columns past D are zero
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long rs, int row0, int S,
                                          int D) {
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, gr = row0 + r;
    dst[r * LD + d] = gr < S && d < D ? to_f<T>(base[gr * rs + d]) : 0.f;
  }
}

// acc[i][j] += Σ_x A(row tr + 8i, x)·B(x, col tc + 16j) for x < depth.
// A is stored [row][x] (lda a row) or, with AT, [x][row]; B is stored
// [col][x] (ldb a col) with BT, or [x][col].
template <int R, int C, bool AT, bool BT>
__device__ __forceinline__ void mm(float (&acc)[R][C], const float* A,
                                   int lda, const float* B, int ldb,
                                   int depth, int tr, int tc) {
#pragma unroll 2
  for (int x = 0; x < depth; ++x) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = AT ? A[x * lda + tr + kTR * i] : A[(tr + kTR * i) * lda + x];
#pragma unroll
    for (int j = 0; j < C; ++j)
      bv[j] = BT ? B[(tc + kTC * j) * ldb + x] : B[x * ldb + tc + kTC * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// a value reduced over the 16 threads of a row group (one half-warp)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the last key row `last_row` can see (+1), capped at Sk: keys at or past
// it are masked for every row up to last_row
__device__ __forceinline__ int key_end(const FlashArgs& a, const Head& hd,
                                       int last_row) {
  if (!a.causal) return a.Sk;
  const long long e = (long long)last_row + hd.off + 1;
  return e < 0 ? 0 : (e < a.Sk ? (int)e : a.Sk);
}

// ---- forward: a block per (BQ-row q tile, batch·head) ----------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_generic(const FlashArgs a, const int D) {
  using G = Tiles<DP>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, LP = BK + 1;
  constexpr int R = BQ / kTR, CS = BK / kTC, CO = DP / kTC;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  const Head hd = head_of(a, bh);
  const T* q = static_cast<const T*>(a.q) + hd.b * a.q_bs + hd.h * D;
  const T* k = static_cast<const T*>(a.k) + hd.b * a.k_bs + hd.h * D;
  const T* v = static_cast<const T*>(a.v) + hd.b * a.v_bs + hd.h * D;
  load_tile<T, BQ, DP>(sQ, q, a.q_rs, q0, a.Sq, D);

  float o[R][CO], m[R], l[R];
  unsigned rh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    rh[i] = a.seed ? row_hash(a, hd, q0 + tr + kTR * i) : 0u;
#pragma unroll
    for (int j = 0; j < CO; ++j) o[i][j] = 0.f;
  }
  const int kend = key_end(a, hd, min(q0 + BQ, a.Sq) - 1);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                        // the last tile's PV is done
    load_tile<T, BK, DP>(sK, k, a.k_rs, k0, a.Sk, D);
    load_tile<T, BK, DP>(sV, v, a.v_rs, k0, a.Sk, D);
    __syncthreads();
    float s[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
    mm<R, CS, false, true>(s, sQ, LD, sK, LD, D, tr, tc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q0 + tr + kTR * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int c = k0 + tc + kTC * j;
        s[i][j] = score<true>(a, hd, s[i][j], r, c, col_bias(a, hd, c));
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(tmax));
      const float base = mn == -INFINITY ? 0.f : mn;  // no key seen yet
      const float alpha = expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int c = k0 + tc + kTC * j;
        const float p = expf(s[i][j] - base);
        rs += p;
        float pd = p;                       // l sums the undropped p
        if (a.seed)
          pd = keep(a, rh[i] + col_hash(a, hd, c)) ? p * a.drop_scale : 0.f;
        sP[(tr + kTR * i) * LP + tc + kTC * j] = round_to<T>(pd);
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < CO; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    mm<R, CO, false, false>(o, sP, LP, sV, LD, BK, tr, tc);
  }

  // a row that saw no key (l = 0) gives o = 0 and lse = NEG_INF
  T* out = static_cast<T*>(a.o) + hd.b * a.o_bs + hd.h * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + tr + kTR * i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int d = tc + kTC * j;
      if (d < D) out[r * a.o_rs + d] = from_f<T>(l[i] > 0.f ? o[i][j] / l[i]
                                                             : 0.f);
    }
    if (tc == 0)
      a.lse[(long long)bh * a.Sq + r] = l[i] > 0.f ? m[i] + logf(l[i])
                                                   : NEG_INF;
  }
}

// ---- backward: the elementwise step shared by both kernels -----------------

// p = exp(s − lse) at (r, c) from the raw q·k product; returns p and sets
// dp to keep·dp/(1 − rate) and pv to keep·p/(1 − rate) (p, dp without
// dropout). `rh`/`ch` are the row's and column's hash terms.
__device__ __forceinline__ float bwd_elem(const FlashArgs& a, const Head& hd,
                                          float raw, int r, int c, float bc,
                                          float lse, unsigned rh,
                                          unsigned ch, float& dp,
                                          float& pv) {
  const float p = expf(score<true>(a, hd, raw, r, c, bc) - lse);
  pv = p;
  if (a.seed) {
    const bool kp = keep(a, rh + ch);
    pv = kp ? p * a.drop_scale : 0.f;
    dp = kp ? dp * a.drop_scale : 0.f;
  }
  return p;
}

// ---- dQ: a block per (BQ-row q tile, batch·head), looping over k tiles -----

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_generic(const FlashArgs a, const int D) {
  using G = Tiles<DP>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, LP = BK + 1;
  constexpr int R = BQ / kTR, CS = BK / kTC, CO = DP / kTC;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sDS = sV + BK * LD;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  const Head hd = head_of(a, bh);
  const T* q = static_cast<const T*>(a.q) + hd.b * a.q_bs + hd.h * D;
  const T* k = static_cast<const T*>(a.k) + hd.b * a.k_bs + hd.h * D;
  const T* v = static_cast<const T*>(a.v) + hd.b * a.v_bs + hd.h * D;
  const T* dout = static_cast<const T*>(a.dout) + hd.b * a.do_bs + hd.h * D;
  load_tile<T, BQ, DP>(sQ, q, a.q_rs, q0, a.Sq, D);
  load_tile<T, BQ, DP>(sDO, dout, a.do_rs, q0, a.Sq, D);

  float acc[R][CO], lse[R], delta[R];
  unsigned rh[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + tr + kTR * i;
    const bool in = r < a.Sq;
    lse[i] = in ? a.lse[(long long)bh * a.Sq + r] : 0.f;
    delta[i] = in ? a.delta[(long long)bh * a.Sq + r] : 0.f;
    rh[i] = a.seed ? row_hash(a, hd, r) : 0u;
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;
  }
  const int kend = key_end(a, hd, min(q0 + BQ, a.Sq) - 1);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                        // the last tile's dS·K is done
    load_tile<T, BK, DP>(sK, k, a.k_rs, k0, a.Sk, D);
    load_tile<T, BK, DP>(sV, v, a.v_rs, k0, a.Sk, D);
    __syncthreads();
    float s[R][CS], dp[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = dp[i][j] = 0.f;
    mm<R, CS, false, true>(s, sQ, LD, sK, LD, D, tr, tc);
    mm<R, CS, false, true>(dp, sDO, LD, sV, LD, D, tr, tc);
#pragma unroll
    for (int j = 0; j < CS; ++j) {
      const int c = k0 + tc + kTC * j;
      const float bc = col_bias(a, hd, c);
      const unsigned ch = a.seed ? col_hash(a, hd, c) : 0u;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float pv;
        const float p = bwd_elem(a, hd, s[i][j], q0 + tr + kTR * i, c, bc,
                                 lse[i], rh[i], ch, dp[i][j], pv);
        sDS[(tr + kTR * i) * LP + tc + kTC * j] =
            round_to<T>(p * (dp[i][j] - delta[i]));
      }
    }
    __syncthreads();
    mm<R, CO, false, false>(acc, sDS, LP, sK, LD, BK, tr, tc);
  }

  T* dq = static_cast<T*>(a.dq) + hd.b * a.dq_bs + hd.h * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + tr + kTR * i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int d = tc + kTC * j;
      if (d < D) dq[r * a.dq_rs + d] = from_f<T>(acc[i][j] * a.scale);
    }
  }
}

// ---- dK, dV: a block per (BK-key tile, batch·head), looping over q tiles ---

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_generic(const FlashArgs a, const int D) {
  using G = Tiles<DP>;
  constexpr int BK = G::KBK, BQ = G::KBQ, LD = G::LD, LP = BK + 1;
  constexpr int R = BQ / kTR, CS = BK / kTC;      // the (q, key) tiles
  constexpr int RK = BK / kTR, CO = DP / kTC;     // dK, dV
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sPV = sDO + BQ * LD;
  float* sDS = sPV + BQ * LP;
  float* sL = sDS + BQ * LP;
  float* sDl = sL + BQ;

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  const Head hd = head_of(a, bh);
  const T* q = static_cast<const T*>(a.q) + hd.b * a.q_bs + hd.h * D;
  const T* k = static_cast<const T*>(a.k) + hd.b * a.k_bs + hd.h * D;
  const T* v = static_cast<const T*>(a.v) + hd.b * a.v_bs + hd.h * D;
  const T* dout = static_cast<const T*>(a.dout) + hd.b * a.do_bs + hd.h * D;
  load_tile<T, BK, DP>(sK, k, a.k_rs, k0, a.Sk, D);
  load_tile<T, BK, DP>(sV, v, a.v_rs, k0, a.Sk, D);

  float dk[RK][CO], dv[RK][CO], bc[CS];
  unsigned ch[CS];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CO; ++j) dk[i][j] = dv[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < CS; ++j) {
    const int c = k0 + tc + kTC * j;
    bc[j] = col_bias(a, hd, c);
    ch[j] = a.seed ? col_hash(a, hd, c) : 0u;
  }
  // rows before the causal frontier of the tile's first key see none of it
  int qstart = 0;
  if (a.causal) {
    const long long first = (long long)k0 - hd.off;
    qstart = first <= 0 ? 0 : (first < a.Sq ? (int)first : a.Sq);
    qstart -= qstart % BQ;
  }
  for (int q0 = qstart; q0 < a.Sq; q0 += BQ) {
    __syncthreads();                        // the last tile's products done
    load_tile<T, BQ, DP>(sQ, q, a.q_rs, q0, a.Sq, D);
    load_tile<T, BQ, DP>(sDO, dout, a.do_rs, q0, a.Sq, D);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < a.Sq;
      sL[i] = in ? a.lse[(long long)bh * a.Sq + q0 + i] : 0.f;
      sDl[i] = in ? a.delta[(long long)bh * a.Sq + q0 + i] : 0.f;
    }
    __syncthreads();
    float s[R][CS], dp[R][CS];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = dp[i][j] = 0.f;
    mm<R, CS, false, true>(s, sQ, LD, sK, LD, D, tr, tc);
    mm<R, CS, false, true>(dp, sDO, LD, sV, LD, D, tr, tc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int rl = tr + kTR * i, r = q0 + rl;
      const unsigned rh = a.seed ? row_hash(a, hd, r) : 0u;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        float pv;
        const float p = bwd_elem(a, hd, s[i][j], r, k0 + tc + kTC * j, bc[j],
                                 sL[rl], rh, ch[j], dp[i][j], pv);
        sPV[rl * LP + tc + kTC * j] = round_to<T>(pv);
        sDS[rl * LP + tc + kTC * j] = round_to<T>(p * (dp[i][j] - sDl[rl]));
      }
    }
    __syncthreads();
    mm<RK, CO, true, false>(dv, sPV, LP, sDO, LD, BQ, tr, tc);
    mm<RK, CO, true, false>(dk, sDS, LP, sQ, LD, BQ, tr, tc);
  }

  T* gdk = static_cast<T*>(a.dk) + hd.b * a.dkv_bs + hd.h * D;
  T* gdv = static_cast<T*>(a.dv) + hd.b * a.dkv_bs + hd.h * D;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = k0 + tr + kTR * i;
    if (c >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int d = tc + kTC * j;
      if (d < D) {
        gdk[c * a.dkv_rs + d] = from_f<T>(dk[i][j] * a.scale);
        gdv[c * a.dkv_rs + d] = from_f<T>(dv[i][j]);
      }
    }
  }
}

// ---- launches -----------------------------------------------------------------

template <typename T, int DP>
int fwd(const FlashArgs& a, int d, cudaStream_t st) {
  using G = Tiles<DP>;
  const void* kern = (const void*)flash_fwd_generic<T, DP>;
  int err = smem_optin(kern, G::fwd_bytes);
  if (err) return err;
  const dim3 grid((a.Sq + G::BQ - 1) / G::BQ, a.B * a.H);
  flash_fwd_generic<T, DP><<<grid, kThreads, G::fwd_bytes, st>>>(a, d);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd(const FlashArgs& a, int d, cudaStream_t st) {
  using G = Tiles<DP>;
  int err = smem_optin((const void*)flash_bwd_dkv_generic<T, DP>,
                       G::dkv_bytes);
  if (!err)
    err = smem_optin((const void*)flash_bwd_dq_generic<T, DP>, G::dq_bytes);
  if (err) return err;
  const dim3 kv_grid((a.Sk + G::KBK - 1) / G::KBK, a.B * a.H);
  flash_bwd_dkv_generic<T, DP><<<kv_grid, kThreads, G::dkv_bytes, st>>>(a, d);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 q_grid((a.Sq + G::BQ - 1) / G::BQ, a.B * a.H);
  flash_bwd_dq_generic<T, DP><<<q_grid, kThreads, G::dq_bytes, st>>>(a, d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(bool forward, const FlashArgs& a, int d, cudaStream_t st) {
  if (d <= 64) return forward ? fwd<T, 64>(a, d, st) : bwd<T, 64>(a, d, st);
  if (d <= 128)
    return forward ? fwd<T, 128>(a, d, st) : bwd<T, 128>(a, d, st);
  return forward ? fwd<T, 256>(a, d, st) : bwd<T, 256>(a, d, st);
}

int entry(bool forward, int dtype, int d, const FlashArgs* a, void* stream) {
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<__nv_bfloat16>(forward, *a, d, st);
  if (dtype == 1) return dispatch<__half>(forward, *a, d, st);
  if (dtype == 2) return dispatch<float>(forward, *a, d, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16, 2 = f32; 1 <= d <= 256. Return a cudaError_t
// (0 = launched; the backward launches the dK/dV kernel, then dQ).
extern "C" int apex_flash_attn_generic_fwd(int dtype, int d,
                                           const FlashArgs* a,
                                           void* stream) {
  return entry(true, dtype, d, a, stream);
}

extern "C" int apex_flash_attn_generic_bwd(int dtype, int d,
                                           const FlashArgs* a,
                                           void* stream) {
  return entry(false, dtype, d, a, stream);
}
