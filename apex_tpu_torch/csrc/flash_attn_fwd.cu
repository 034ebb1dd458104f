// Flash-attention forward for Hopper (sm_90a), bf16/fp16 in, f32 softmax.
//
// Replaces apex_tpu/ops/attention.py::_fwd_kernel_nl (the pallas_call in
// _flash_fwd_nl) and _fwd_kernel (_flash_fwd, the (B·H, S, D) layout the
// JAX package falls back to when heads do not group into 128 lanes): online-
// softmax attention giving o in the input dtype and lse = m + log(l) in
// f32, (B·H, Sq), with the whole function of those kernels: an additive f32
// bias broadcast over any of (B, H, Sq, Sk), a causal frontier (row r sees
// key c iff r + off >= c; off read from the device or Sk − Sq), Sq ≠ Sk,
// and softmax dropout whose mask is the JAX package's hash, bit for bit.
// P is cast to v's dtype before the PV product, as the TPU kernel does; l
// sums the undropped f32 probabilities, and only the PV product sees
// keep·p/(1 − rate). A row that sees no key gives o = 0 and lse = -1e30, as
// the JAX package's single-block kernel does.
//
// What bounds it on an H100: both sides nearly equally. At the BERT shape
// (B16, S512, H16, D64) the two products are 4·B·H·S²·D = 17.2 GFLOP
// (17 us at the bf16 tensor-core peak) against q, k, v and o, 67 MB (20 us
// at 3.35 TB/s): 256 flops per byte, just under the card's ridge. Dropout
// adds ~20 integer operations per score element (67M elements: 1.3 G).
//
// Design: one block of 4 warps per (64-row q tile, batch·head). The q tile
// stays in shared memory; the block walks 64-row k/v tiles, stopping at
// the causal frontier of its last row. Each warp owns 16 q rows: it
// computes its 16x64 score strip with wmma 16x16x16 (f32 accumulate),
// scales it, adds the bias read from device memory (the padding mask's 64
// floats a tile sit in L1), masks it, runs the online max/sum on its rows
// (two columns a lane, shuffle reductions), applies the dropout mask,
// rescales its rows of the f32 output accumulator kept in shared memory,
// and adds P·V with wmma. Only the k/v tile loads need the whole block to
// synchronise. This is the simple first kernel: no TMA, no wgmma, no
// pipelining of the tile loads.
#include "flash_common.cuh"

using namespace nvcuda;
using namespace apex_flash;

namespace {

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * (BM + 2 * BN) * Ld<D>::T      // q, k, v tiles
         + sizeof(float) * BM * Ld<D>::S           // scores
         + sizeof(T) * BM * Ld<D>::P               // probabilities
         + sizeof(float) * BM * Ld<D>::O           // output accumulator
         + sizeof(float) * 2 * BM                  // running max, sum
         + sizeof(unsigned) * BM;                  // dropout row hashes
}

template <typename T, int D, bool OPTS>
__global__ void __launch_bounds__(NTHREADS) flash_fwd(const FlashArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * Ld<D>::T;
  T* sV = sK + BN * Ld<D>::T;
  float* sS = reinterpret_cast<float*>(sV + BN * Ld<D>::T);
  T* sP = reinterpret_cast<T*>(sS + BM * Ld<D>::S);
  float* sO = reinterpret_cast<float*>(sP + BM * Ld<D>::P);
  float* sM = sO + BM * Ld<D>::O;
  float* sL = sM + BM;
  unsigned* sHr = reinterpret_cast<unsigned*>(sL + BM);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const Head hd = head_of(a, bh);
  const int q0 = blockIdx.x * BM;
  const int w0 = warp * 16;                 // this warp's first tile row
  const T* q = static_cast<const T*>(a.q) + hd.b * a.q_bs + hd.h * D;
  const T* k = static_cast<const T*>(a.k) + hd.b * a.k_bs + hd.h * D;
  const T* v = static_cast<const T*>(a.v) + hd.b * a.v_bs + hd.h * D;

  load_tile<T, D>(sQ, q, a.q_rs, q0, a.Sq);
  for (int i = threadIdx.x; i < BM * Ld<D>::O; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
    if (OPTS && a.seed) sHr[i] = row_hash(a, hd, q0 + i);
  }

  // keys past the causal frontier of the tile's last row are all masked
  int k_end = a.Sk;
  if (OPTS && a.causal) k_end = min(k_end, min(q0 + BM, a.Sq) + hd.off);
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();                        // previous tile fully consumed
    load_tile<T, D>(sK, k, a.k_rs, k0, a.Sk);
    load_tile<T, D>(sV, v, a.v_rs, k0, a.Sk);
    __syncthreads();

    // scores: this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sQ + w0 * Ld<D>::T + kk * 16, Ld<D>::T);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + j * 16 * Ld<D>::T + kk * 16,
                                 Ld<D>::T);
          wmma::mma_sync(acc[j], fa, bk, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wmma::store_matrix_sync(sS + w0 * Ld<D>::S + j * 16, acc[j], Ld<D>::S,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this warp's rows
    const int c0 = k0 + lane, c1 = k0 + lane + 32;
    unsigned h0 = 0u, h1 = 0u;
    float b0 = 0.f, b1 = 0.f;
    if (OPTS) {
      b0 = col_bias(a, hd, c0);
      b1 = col_bias(a, hd, c1);
      if (a.seed) {
        h0 = col_hash(a, hd, c0);
        h1 = col_hash(a, hd, c1);
      }
    }
    for (int r = 0; r < 16; ++r) {
      const int row = w0 + r, rg = q0 + row;
      const float s0 =
          score<OPTS>(a, hd, sS[row * Ld<D>::S + lane], rg, c0, b0);
      const float s1 =
          score<OPTS>(a, hd, sS[row * Ld<D>::S + lane + 32], rg, c1, b1);
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // a row with no key yet keeps m = -inf; exp against 0 gives p = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
      const float alpha = expf(m_old - m_use);
      const float psum = warp_sum(p0 + p1);      // l sums the undropped p
      if (OPTS && a.seed) {
        const unsigned hr = sHr[row];
        p0 = keep(a, hr + h0) ? p0 * a.drop_scale : 0.f;
        p1 = keep(a, hr + h1) ? p1 * a.drop_scale : 0.f;
      }
      sP[row * Ld<D>::P + lane] = from_float<T>(p0);
      sP[row * Ld<D>::P + lane + 32] = from_float<T>(p1);
      for (int c = lane; c < D; c += 32) sO[row * Ld<D>::O + c] *= alpha;
      __syncwarp();                         // every lane has read sM[row]
      if (lane == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + psum;
      }
    }
    __syncwarp();

    // O[rows] += P[rows] · V
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + w0 * Ld<D>::O + jd * 16, Ld<D>::O,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(fp, sP + w0 * Ld<D>::P + kk * 16, Ld<D>::P);
        wmma::load_matrix_sync(bv, sV + kk * 16 * Ld<D>::T + jd * 16,
                               Ld<D>::T);
        wmma::mma_sync(acc, fp, bv, acc);
      }
      wmma::store_matrix_sync(sO + w0 * Ld<D>::O + jd * 16, acc, Ld<D>::O,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();                          // initialised state, if no tile ran

  // epilogue: o = acc / l, lse = m + log(l), this warp's rows; a row that
  // saw no key (l = 0) gives o = 0 and lse = NEG_INF
  T* ob = static_cast<T*>(a.o) + hd.b * a.o_bs + hd.h * D;
  for (int r = 0; r < 16; ++r) {
    const int row = w0 + r;
    if (q0 + row >= a.Sq) break;
    const float l = sL[row];
    for (int c = lane; c < D; c += 32)
      ob[(long long)(q0 + row) * a.o_rs + c] =
          from_float<T>(l > 0.f ? sO[row * Ld<D>::O + c] / l : 0.f);
    if (lane == 0)
      a.lse[(long long)bh * a.Sq + q0 + row] =
          l > 0.f ? sM[row] + logf(l) : NEG_INF;
  }
}

template <typename T, int D, bool OPTS>
int launch_opts(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  int err = smem_optin((const void*)flash_fwd<T, D, OPTS>, smem);
  if (err) return err;
  dim3 grid((a.Sq + BM - 1) / BM, a.B * a.H);
  flash_fwd<T, D, OPTS><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  return a.bias || a.causal || a.seed ? launch_opts<T, D, true>(a, stream)
                                      : launch_opts<T, D, false>(a, stream);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16; d: 32, 64 or 128. Returns a cudaError_t
// (0 = launched).
extern "C" int apex_flash_attn_fwd(int dtype, int d, const FlashArgs* a,
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
