// Flash-attention forward for Hopper (sm_90a), bf16/fp16 in, f32 softmax.
//
// Replaces apex_tpu/ops/attention.py::_fwd_kernel_nl (the pallas_call in
// _flash_fwd_nl): online-softmax attention over the (B, S, H·D) native
// layout, giving o in the input dtype and lse = m + log(l) in f32,
// (B·H, S). P is cast to v's dtype before the PV product, as the TPU kernel
// does; l sums the f32 probabilities.
//
// What bounds it on an H100: both sides nearly equally. At the BERT shape
// (B16, S512, H16, D64) the two products are 4·B·H·S²·D = 17.2 GFLOP
// (17 us at the bf16 tensor-core peak) against q, k, v and o, 67 MB (20 us
// at 3.35 TB/s): 256 flops per byte, just under the card's ridge.
//
// Design: one block of 4 warps per (64-row q tile, batch·head). The q tile
// stays in shared memory; the block walks 64-row k/v tiles. Each warp owns
// 16 q rows: it computes its 16x64 score strip with wmma 16x16x16 (f32
// accumulate), runs the online max/sum on its rows (two columns a lane,
// shuffle reductions), rescales its rows of the f32 output accumulator
// kept in shared memory, and adds P·V with wmma. Only the k/v tile loads
// need the whole block to synchronise. Keys past S are masked with -inf;
// q rows past S are zero and never stored. This is the simple first
// kernel: no TMA, no wgmma, no pipelining of the tile loads.
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
         + sizeof(float) * 2 * BM;                 // running max, sum
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int S, int H, long long q_bs, long long q_rs, long long k_bs,
          long long k_rs, long long v_bs, long long v_rs, long long o_bs,
          long long o_rs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * Ld<D>::T;
  T* sV = sK + BN * Ld<D>::T;
  float* sS = reinterpret_cast<float*>(sV + BN * Ld<D>::T);
  T* sP = reinterpret_cast<T*>(sS + BM * Ld<D>::S);
  float* sO = reinterpret_cast<float*>(sP + BM * Ld<D>::P);
  float* sM = sO + BM * Ld<D>::O;
  float* sL = sM + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int w0 = warp * 16;                 // this warp's first tile row

  load_tile<T, D>(sQ, q + b * q_bs + h * D, q_rs, q0, S);
  for (int i = threadIdx.x; i < BM * Ld<D>::O; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BN) {
    __syncthreads();                        // previous tile fully consumed
    load_tile<T, D>(sK, k + b * k_bs + h * D, k_rs, k0, S);
    load_tile<T, D>(sV, v + b * v_bs + h * D, v_rs, k0, S);
    __syncthreads();

    // scores: this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + w0 * Ld<D>::T + kk * 16, Ld<D>::T);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + j * 16 * Ld<D>::T + kk * 16,
                                 Ld<D>::T);
          wmma::mma_sync(acc[j], a, bk, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wmma::store_matrix_sync(sS + w0 * Ld<D>::S + j * 16, acc[j], Ld<D>::S,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this warp's rows
    for (int r = 0; r < 16; ++r) {
      const int row = w0 + r;
      float s0 = sS[row * Ld<D>::S + lane] * scale;
      float s1 = sS[row * Ld<D>::S + lane + 32] * scale;
      if (k0 + lane >= S) s0 = -INFINITY;
      if (k0 + lane + 32 >= S) s1 = -INFINITY;
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + w0 * Ld<D>::P + kk * 16, Ld<D>::P);
        wmma::load_matrix_sync(bv, sV + kk * 16 * Ld<D>::T + jd * 16,
                               Ld<D>::T);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sO + w0 * Ld<D>::O + jd * 16, acc, Ld<D>::O,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // epilogue: o = acc / l, lse = m + log(l), this warp's rows
  T* ob = o + b * o_bs + h * D;
  for (int r = 0; r < 16; ++r) {
    const int row = w0 + r;
    if (q0 + row >= S) break;
    const float l = sL[row];
    for (int c = lane; c < D; c += 32)
      ob[(long long)(q0 + row) * o_rs + c] =
          from_float<T>(sO[row * Ld<D>::O + c] / l);
    if (lane == 0) lse[(long long)bh * S + q0 + row] = sM[row] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, long long q_bs, long long q_rs, long long k_bs,
           long long k_rs, long long v_bs, long long v_rs, long long o_bs,
           long long o_rs, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  int err = smem_optin((const void*)flash_fwd<T, D>, smem);
  if (err) return err;
  dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, H, q_bs, q_rs,
      k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. Returns a cudaError_t (0 = launched).
extern "C" int apex_flash_attn_fwd(int dtype, int d, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, int B, int S, int H,
                                   long long q_bs, long long q_rs,
                                   long long k_bs, long long k_rs,
                                   long long v_bs, long long v_rs,
                                   long long o_bs, long long o_rs, float scale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define APEX_FWD(T, D_)                                                        \
  return launch<T, D_>(q, k, v, o, lse, B, S, H, q_bs, q_rs, k_bs, k_rs, v_bs, \
                       v_rs, o_bs, o_rs, scale, st)
  if (dtype == 0 && d == 64) APEX_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && d == 64) APEX_FWD(__half, 64);
#undef APEX_FWD
  return (int)cudaErrorInvalidValue;
}
