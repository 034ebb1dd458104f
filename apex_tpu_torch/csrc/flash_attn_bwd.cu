// Flash-attention backward for Hopper (sm_90a): two kernels, no atomics.
//
// Replaces apex_tpu/ops/attention.py::_bwd_fused_kernel_nl (the
// single-block sweep BERT's S=512 takes, pallas_call in
// _flash_bwd_fused_nl) and the split pair _bwd_dq_kernel_nl /
// _bwd_dkv_kernel_nl (_flash_bwd_nl). Per head, with P = exp(s·scale − lse)
// recomputed from the forward's lse and delta = Σ do·o (computed by the
// caller, as the JAX package computes it in jnp):
//   dV = Pᵀ·dO  (P cast to dO's dtype)
//   dS = P ∘ (dO·Vᵀ − delta)  (cast to q's dtype)
//   dK = dSᵀ·Q·scale,  dQ = dS·K·scale
//
// What bounds it on an H100: operations. At the BERT shape the five
// products of the function are 10·B·H·S²·D = 42.9 GFLOP (43 us at the
// bf16 tensor-core peak) against q, k, v, do, dq, dk, dv, 117 MB (35 us).
//
// Design: the TPU's fused single sweep holds the whole sequence in one
// block, which does not carry over to Hopper's 227 KB of shared memory and
// unordered blocks. Instead, flash_bwd_dkv runs one block per (64-key tile,
// batch·head) looping over the q tiles, and flash_bwd_dq one block per
// (64-row q tile, batch·head) looping over the k tiles. Each block owns its
// output rows outright, so no accumulation crosses blocks and the result
// is deterministic; the price is that both kernels recompute s and dP. The
// dK/dV and dQ sums stay in wmma accumulator fragments (f32) across the
// loop; products are wmma 16x16x16. Rows and keys past S are masked to
// P = 0. This is the simple first kernel: no TMA, no wgmma, no pipelining.
#include "flash_common.cuh"

using namespace nvcuda;
using namespace apex_flash;

namespace {

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// f32 region for the score and dP tiles, reused as output staging at the
// end (staging needs BM x Ld<D>::O floats)
template <int D> struct ScoreRegion {
  static constexpr int floats = 2 * BM * Ld<D>::S > BM * Ld<D>::O
                                    ? 2 * BM * Ld<D>::S
                                    : BM * Ld<D>::O;
};

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(T) * 4 * 64 * Ld<D>::T       // q, do, k, v tiles
         + sizeof(float) * ScoreRegion<D>::floats  // s and dP (f32), staging
         + sizeof(T) * 2 * 64 * Ld<D>::P      // P and dS (16-bit)
         + sizeof(float) * 2 * BM;            // lse, delta
}

// this warp's 16 rows of A·Bᵀ (A rows from `a`, B rows from `bm`, both 64
// rows of D in shared memory) into an f32 tile with leading dim Ld<D>::S
template <typename T, int D>
__device__ __forceinline__ void rows_abt(float* out, const T* a, const T* bm,
                                         int w0) {
  FragAcc acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + w0 * Ld<D>::T + kk * 16, Ld<D>::T);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, bm + j * 16 * Ld<D>::T + kk * 16, Ld<D>::T);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(out + w0 * Ld<D>::S + j * 16, acc[j], Ld<D>::S,
                            wmma::mem_row_major);
}

// this warp's 16 q rows: P and dS (16-bit) from the f32 s and dP tiles
template <typename T, int D>
__device__ __forceinline__ void probs_rows(T* sP, T* sdS, const float* sS,
                                           const float* sdP, const float* sLse,
                                           const float* sDelta, int w0,
                                           int q0, int k0, int S, float scale) {
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < 16; ++r) {
    const int row = w0 + r;
    const bool row_ok = q0 + row < S;
    for (int c = lane; c < BN; c += 32) {
      float p = 0.f;
      if (row_ok && k0 + c < S)
        p = expf(sS[row * Ld<D>::S + c] * scale - sLse[row]);
      const float ds = p * (sdP[row * Ld<D>::S + c] - sDelta[row]);
      sP[row * Ld<D>::P + c] = from_float<T>(p);
      sdS[row * Ld<D>::P + c] = from_float<T>(ds);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_rowvec(float* dst, const float* src,
                                            int r0, int S) {
  for (int i = threadIdx.x; i < BM; i += NTHREADS)
    dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
}

// One block per (64-key tile, batch·head): dK, dV for its keys.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int S, int H,
              long long q_bs, long long q_rs, long long k_bs, long long k_rs,
              long long v_bs, long long v_rs, long long do_bs, long long do_rs,
              long long g_bs, long long g_rs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + 64 * Ld<D>::T;
  T* sK = sdO + 64 * Ld<D>::T;
  T* sV = sK + 64 * Ld<D>::T;
  float* sS = reinterpret_cast<float*>(sV + 64 * Ld<D>::T);
  float* sdP = sS + BM * Ld<D>::S;
  T* sP = reinterpret_cast<T*>(sS + ScoreRegion<D>::floats);
  T* sdS = sP + 64 * Ld<D>::P;
  float* sLse = reinterpret_cast<float*>(sdS + 64 * Ld<D>::P);
  float* sDelta = sLse + BM;

  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BN;
  const int w0 = warp * 16;   // q rows of s/dP; key rows of dK/dV

  load_tile<T, D>(sK, k + b * k_bs + h * D, k_rs, k0, S);
  load_tile<T, D>(sV, v + b * v_bs + h * D, v_rs, k0, S);

  FragAcc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  for (int q0 = 0; q0 < S; q0 += BM) {
    __syncthreads();                        // previous q tile consumed
    load_tile<T, D>(sQ, q + b * q_bs + h * D, q_rs, q0, S);
    load_tile<T, D>(sdO, dout + b * do_bs + h * D, do_rs, q0, S);
    load_rowvec<T, D>(sLse, lse + (long long)bh * S, q0, S);
    load_rowvec<T, D>(sDelta, delta + (long long)bh * S, q0, S);
    __syncthreads();

    rows_abt<T, D>(sS, sQ, sK, w0);         // s  = Q·Kᵀ
    rows_abt<T, D>(sdP, sdO, sV, w0);       // dP = dO·Vᵀ
    __syncwarp();
    probs_rows<T, D>(sP, sdS, sS, sdP, sLse, sDelta, w0, q0, k0, S, scale);
    __syncthreads();                        // all q rows of P, dS ready

    // dV[keys] += Pᵀ·dO ; dK[keys] += dSᵀ·Q   (contraction over q rows)
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> pt, dst;
      wmma::load_matrix_sync(pt, sP + kk * 16 * Ld<D>::P + w0, Ld<D>::P);
      wmma::load_matrix_sync(dst, sdS + kk * 16 * Ld<D>::P + w0, Ld<D>::P);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fdo, fq;
        wmma::load_matrix_sync(fdo, sdO + kk * 16 * Ld<D>::T + jd * 16,
                               Ld<D>::T);
        wmma::load_matrix_sync(fq, sQ + kk * 16 * Ld<D>::T + jd * 16,
                               Ld<D>::T);
        wmma::mma_sync(dv_acc[jd], pt, fdo, dv_acc[jd]);
        wmma::mma_sync(dk_acc[jd], dst, fq, dk_acc[jd]);
      }
    }
  }
  __syncthreads();                          // score region free for staging

  float* stage = sS;
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + w0 * Ld<D>::O + jd * 16, dv_acc[jd],
                            Ld<D>::O, wmma::mem_row_major);
  __syncwarp();
  store_rows<T, D>(dv + b * g_bs + h * D, g_rs, stage, k0, S, 1.f);
  __syncwarp();
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + w0 * Ld<D>::O + jd * 16, dk_acc[jd],
                            Ld<D>::O, wmma::mem_row_major);
  __syncwarp();
  store_rows<T, D>(dk + b * g_bs + h * D, g_rs, stage, k0, S, scale);
}

// One block per (64-row q tile, batch·head): dQ for its rows.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int S, int H, long long q_bs, long long q_rs,
             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
             long long do_bs, long long do_rs, long long g_bs, long long g_rs,
             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + 64 * Ld<D>::T;
  T* sK = sdO + 64 * Ld<D>::T;
  T* sV = sK + 64 * Ld<D>::T;
  float* sS = reinterpret_cast<float*>(sV + 64 * Ld<D>::T);
  float* sdP = sS + BM * Ld<D>::S;
  T* sP = reinterpret_cast<T*>(sS + ScoreRegion<D>::floats);
  T* sdS = sP + 64 * Ld<D>::P;
  float* sLse = reinterpret_cast<float*>(sdS + 64 * Ld<D>::P);
  float* sDelta = sLse + BM;

  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int w0 = warp * 16;

  load_tile<T, D>(sQ, q + b * q_bs + h * D, q_rs, q0, S);
  load_tile<T, D>(sdO, dout + b * do_bs + h * D, do_rs, q0, S);
  load_rowvec<T, D>(sLse, lse + (long long)bh * S, q0, S);
  load_rowvec<T, D>(sDelta, delta + (long long)bh * S, q0, S);

  FragAcc dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);

  for (int k0 = 0; k0 < S; k0 += BN) {
    __syncthreads();                        // previous k tile consumed
    load_tile<T, D>(sK, k + b * k_bs + h * D, k_rs, k0, S);
    load_tile<T, D>(sV, v + b * v_bs + h * D, v_rs, k0, S);
    __syncthreads();

    rows_abt<T, D>(sS, sQ, sK, w0);
    rows_abt<T, D>(sdP, sdO, sV, w0);
    __syncwarp();
    probs_rows<T, D>(sP, sdS, sS, sdP, sLse, sDelta, w0, q0, k0, S, scale);
    __syncwarp();

    // dQ[rows] += dS[rows]·K   (contraction over keys)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fds;
      wmma::load_matrix_sync(fds, sdS + w0 * Ld<D>::P + kk * 16, Ld<D>::P);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fk;
        wmma::load_matrix_sync(fk, sK + kk * 16 * Ld<D>::T + jd * 16,
                               Ld<D>::T);
        wmma::mma_sync(dq_acc[jd], fds, fk, dq_acc[jd]);
      }
    }
  }
  __syncthreads();

  float* stage = sS;
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + w0 * Ld<D>::O + jd * 16, dq_acc[jd],
                            Ld<D>::O, wmma::mem_row_major);
  __syncwarp();
  store_rows<T, D>(dq + b * g_bs + h * D, g_rs, stage, q0, S, scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, int S, int H, long long q_bs, long long q_rs, long long k_bs,
           long long k_rs, long long v_bs, long long v_rs, long long do_bs,
           long long do_rs, long long g_bs, long long g_rs, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T, D>();
  int err = smem_optin((const void*)flash_bwd_dkv<T, D>, smem);
  if (err) return err;
  err = smem_optin((const void*)flash_bwd_dq<T, D>, smem);
  if (err) return err;
  dim3 grid((S + 63) / 64, B * H);
  flash_bwd_dkv<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs,
      g_bs, g_rs, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, H, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, g_bs,
      g_rs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. dq, dk, dv share strides (g_bs, g_rs).
// Returns a cudaError_t (0 = both kernels launched).
extern "C" int apex_flash_attn_bwd(
    int dtype, int d, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    long long do_bs, long long do_rs, long long g_bs, long long g_rs,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define APEX_BWD(T, D_)                                                      \
  return launch<T, D_>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, q_bs, \
                       q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, g_bs,     \
                       g_rs, scale, st)
  if (dtype == 0 && d == 64) APEX_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && d == 64) APEX_BWD(__half, 64);
#undef APEX_BWD
  return (int)cudaErrorInvalidValue;
}
