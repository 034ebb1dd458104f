// Flash-attention backward for Hopper (sm_90a): two kernels, no atomics.
//
// Replaces apex_tpu/ops/attention.py::_bwd_fused_kernel_nl (the
// single-block sweep BERT's S=512 takes, pallas_call in
// _flash_bwd_fused_nl), the split pair _bwd_dq_kernel_nl /
// _bwd_dkv_kernel_nl (_flash_bwd_nl, multi-block sequences and the lse
// variant's shifted delta) and the (B·H, S, D)-layout pair _bwd_dq_kernel /
// _bwd_dkv_kernel (_flash_bwd, heads that do not group into 128 lanes).
// Per head, with P = exp(s − lse) recomputed from the forward's lse (s the
// scaled, biased and masked score; see flash_common.cuh) and delta taken
// from the caller (Σ do·o, minus the lse cotangent for the lse variant):
//   dV = P̃ᵀ·dO  (P̃ = keep·P/(1 − rate), cast to dO's dtype)
//   dS = P ∘ (dP̃ − delta),  dP̃ = keep·(dO·Vᵀ)/(1 − rate)  (cast to q's dtype)
//   dK = dSᵀ·Q·scale,  dQ = dS·K·scale
// with the dropout mask regenerated from the forward's seed, bit for bit.
//
// What bounds it on an H100: operations. At the BERT shape the five
// products of the function are 10·B·H·S²·D = 42.9 GFLOP (43 us at the
// bf16 tensor-core peak) against q, k, v, do, dq, dk, dv, 117 MB (35 us).
//
// Design: the TPU's fused single sweep holds the whole sequence in one
// block, which does not carry over to Hopper's 227 KB of shared memory and
// unordered blocks. Instead, flash_bwd_dkv runs one block per (64-key tile,
// batch·head) looping over the q tiles, and flash_bwd_dq one block per
// (64-row q tile, batch·head) looping over the k tiles; both skip tiles
// wholly past the causal frontier. Each block owns its output rows
// outright, so no accumulation crosses blocks and the result is
// deterministic; the price is that both kernels recompute s, dP and the
// dropout mask. The dK/dV and dQ sums stay in wmma accumulator fragments
// (f32) across the loop; products are wmma 16x16x16. This is the simple
// first kernel: no TMA, no wgmma, no pipelining.
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
         + sizeof(T) * 2 * 64 * Ld<D>::P      // P̃ and dS (16-bit)
         + sizeof(float) * 2 * BM             // lse, delta
         + sizeof(unsigned) * BM;             // dropout row hashes
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

// this warp's 16 q rows: P̃ and dS (16-bit) from the f32 s and dP tiles
template <typename T, int D, bool OPTS>
__device__ __forceinline__ void probs_rows(T* sP, T* sdS, const float* sS,
                                           const float* sdP, const float* sLse,
                                           const float* sDelta,
                                           const unsigned* sHr, int w0,
                                           int q0, int k0, const FlashArgs& a,
                                           const Head& hd) {
  const int lane = threadIdx.x % 32;
  unsigned hc[BN / 32] = {};
  float bc[BN / 32] = {};
  if (OPTS) {
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      bc[j] = col_bias(a, hd, k0 + lane + 32 * j);
      if (a.seed) hc[j] = col_hash(a, hd, k0 + lane + 32 * j);
    }
  }
  for (int r = 0; r < 16; ++r) {
    const int row = w0 + r, rg = q0 + row;
    const unsigned hr = OPTS && a.seed ? sHr[row] : 0u;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int c = lane + 32 * j;
      // masked elements score -inf: p = 0 (rows past Sq load lse 0)
      const float p = expf(score<OPTS>(a, hd, sS[row * Ld<D>::S + c], rg,
                                       k0 + c, bc[j]) - sLse[row]);
      float dp = sdP[row * Ld<D>::S + c], pv = p;
      if (OPTS && a.seed) {
        if (keep(a, hr + hc[j])) {
          pv = p * a.drop_scale;
          dp *= a.drop_scale;
        } else {
          pv = dp = 0.f;
        }
      }
      sP[row * Ld<D>::P + c] = from_float<T>(pv);
      sdS[row * Ld<D>::P + c] = from_float<T>(p * (dp - sDelta[row]));
    }
  }
}

// lse and delta of rows [r0, r0 + BM) (0 past Sq), and with dropout the
// rows' hash terms
template <bool OPTS>
__device__ __forceinline__ void load_rows(float* sLse, float* sDelta,
                                          unsigned* sHr, const float* lse,
                                          const float* delta, int r0,
                                          const FlashArgs& a, const Head& hd) {
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    const bool in = r0 + i < a.Sq;
    sLse[i] = in ? lse[r0 + i] : 0.f;
    sDelta[i] = in ? delta[r0 + i] : 0.f;
    if (OPTS && a.seed) sHr[i] = row_hash(a, hd, r0 + i);
  }
}

// One block per (64-key tile, batch·head): dK, dV for its keys.
template <typename T, int D, bool OPTS>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv(const FlashArgs a) {
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
  unsigned* sHr = reinterpret_cast<unsigned*>(sDelta + BM);

  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y;
  const Head hd = head_of(a, bh);
  const int k0 = blockIdx.x * BN;
  const int w0 = warp * 16;   // q rows of s/dP; key rows of dK/dV
  const T* q = static_cast<const T*>(a.q) + hd.b * a.q_bs + hd.h * D;
  const T* k = static_cast<const T*>(a.k) + hd.b * a.k_bs + hd.h * D;
  const T* v = static_cast<const T*>(a.v) + hd.b * a.v_bs + hd.h * D;
  const T* dout = static_cast<const T*>(a.dout) + hd.b * a.do_bs + hd.h * D;
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* delta = a.delta + (long long)bh * a.Sq;

  load_tile<T, D>(sK, k, a.k_rs, k0, a.Sk);
  load_tile<T, D>(sV, v, a.v_rs, k0, a.Sk);

  FragAcc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  for (int q0 = 0; q0 < a.Sq; q0 += BM) {
    // every row of this q tile is before the frontier of key k0
    if (OPTS && a.causal && min(q0 + BM, a.Sq) - 1 + hd.off < k0) continue;
    __syncthreads();                        // previous q tile consumed
    load_tile<T, D>(sQ, q, a.q_rs, q0, a.Sq);
    load_tile<T, D>(sdO, dout, a.do_rs, q0, a.Sq);
    load_rows<OPTS>(sLse, sDelta, sHr, lse, delta, q0, a, hd);
    __syncthreads();

    rows_abt<T, D>(sS, sQ, sK, w0);         // s  = Q·Kᵀ
    rows_abt<T, D>(sdP, sdO, sV, w0);       // dP = dO·Vᵀ
    __syncwarp();
    probs_rows<T, D, OPTS>(sP, sdS, sS, sdP, sLse, sDelta, sHr, w0, q0, k0,
                           a, hd);
    __syncthreads();                        // all q rows of P̃, dS ready

    // dV[keys] += P̃ᵀ·dO ; dK[keys] += dSᵀ·Q   (contraction over q rows)
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
  T* dkb = static_cast<T*>(a.dk) + hd.b * a.dkv_bs + hd.h * D;
  T* dvb = static_cast<T*>(a.dv) + hd.b * a.dkv_bs + hd.h * D;
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + w0 * Ld<D>::O + jd * 16, dv_acc[jd],
                            Ld<D>::O, wmma::mem_row_major);
  __syncwarp();
  store_rows<T, D>(dvb, a.dkv_rs, stage, k0, a.Sk, 1.f);
  __syncwarp();
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + w0 * Ld<D>::O + jd * 16, dk_acc[jd],
                            Ld<D>::O, wmma::mem_row_major);
  __syncwarp();
  store_rows<T, D>(dkb, a.dkv_rs, stage, k0, a.Sk, a.scale);
}

// One block per (64-row q tile, batch·head): dQ for its rows.
template <typename T, int D, bool OPTS>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq(const FlashArgs a) {
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
  unsigned* sHr = reinterpret_cast<unsigned*>(sDelta + BM);

  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y;
  const Head hd = head_of(a, bh);
  const int q0 = blockIdx.x * BM;
  const int w0 = warp * 16;
  const T* q = static_cast<const T*>(a.q) + hd.b * a.q_bs + hd.h * D;
  const T* k = static_cast<const T*>(a.k) + hd.b * a.k_bs + hd.h * D;
  const T* v = static_cast<const T*>(a.v) + hd.b * a.v_bs + hd.h * D;
  const T* dout = static_cast<const T*>(a.dout) + hd.b * a.do_bs + hd.h * D;

  load_tile<T, D>(sQ, q, a.q_rs, q0, a.Sq);
  load_tile<T, D>(sdO, dout, a.do_rs, q0, a.Sq);
  load_rows<OPTS>(sLse, sDelta, sHr, a.lse + (long long)bh * a.Sq,
                  a.delta + (long long)bh * a.Sq, q0, a, hd);

  FragAcc dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);

  int k_end = a.Sk;
  if (OPTS && a.causal) k_end = min(k_end, min(q0 + BM, a.Sq) + hd.off);
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();                        // previous k tile consumed
    load_tile<T, D>(sK, k, a.k_rs, k0, a.Sk);
    load_tile<T, D>(sV, v, a.v_rs, k0, a.Sk);
    __syncthreads();

    rows_abt<T, D>(sS, sQ, sK, w0);
    rows_abt<T, D>(sdP, sdO, sV, w0);
    __syncwarp();
    probs_rows<T, D, OPTS>(sP, sdS, sS, sdP, sLse, sDelta, sHr, w0, q0, k0,
                           a, hd);
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
  store_rows<T, D>(static_cast<T*>(a.dq) + hd.b * a.dq_bs + hd.h * D, a.dq_rs,
                   stage, q0, a.Sq, a.scale);
}

template <typename T, int D, bool OPTS>
int launch_opts(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T, D>();
  int err = smem_optin((const void*)flash_bwd_dkv<T, D, OPTS>, smem);
  if (err) return err;
  err = smem_optin((const void*)flash_bwd_dq<T, D, OPTS>, smem);
  if (err) return err;
  flash_bwd_dkv<T, D, OPTS><<<dim3((a.Sk + BN - 1) / BN, a.B * a.H), NTHREADS,
                              smem, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq<T, D, OPTS><<<dim3((a.Sq + BM - 1) / BM, a.B * a.H), NTHREADS,
                             smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  return a.bias || a.causal || a.seed ? launch_opts<T, D, true>(a, stream)
                                      : launch_opts<T, D, false>(a, stream);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16; d: 32, 64 or 128. Returns a cudaError_t
// (0 = both kernels launched).
extern "C" int apex_flash_attn_bwd(int dtype, int d, const FlashArgs* a,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && d == 32) return launch<__nv_bfloat16, 32>(*a, st);
  if (dtype == 0 && d == 64) return launch<__nv_bfloat16, 64>(*a, st);
  if (dtype == 0 && d == 128) return launch<__nv_bfloat16, 128>(*a, st);
  if (dtype == 1 && d == 32) return launch<__half, 32>(*a, st);
  if (dtype == 1 && d == 64) return launch<__half, 64>(*a, st);
  if (dtype == 1 && d == 128) return launch<__half, 128>(*a, st);
  return (int)cudaErrorInvalidValue;
}
