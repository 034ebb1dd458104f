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
// at 3.35 TB/s): 256 flops per byte, just under the card's ridge. Past the
// products each score element takes an exponential on the SFU (16 an SM a
// clock, as much time as the tensor cores need for its products at D =
// 64) and a few CUDA-core instructions; dropout adds ~20 integer
// operations per element.
//
// Design (flash_common.cuh has the parts): one persistent block of 288
// threads an SM, taking (128-row q tile, batch·head) items in turn. The
// producer warp loads each item's q tile into one of two buffers and
// streams its BN-key k/v tiles (BN = 128 for D <= 64 without options,
// else 64, to fit the 168 registers a thread) through a three-stage TMA
// ring, stopping at the causal frontier of the tile's last row, while the
// consumers still work on the item before; with options it stages each
// tile's per-key bias and dropout hash terms beside it. Each consumer
// warpgroup owns 64 q rows. S = Q·Kᵀ is a wgmma m64nBNk16 chain (both
// operands K-major); the online softmax runs on the accumulator fragment
// in registers (a row's max and sum take two quad shuffles; exponentials
// are one FFMA and ex2.approx); P goes to 16 bits in registers as the A
// operand of the O += P·V chain, V MN-major; O stays in registers and is
// rescaled there. Within a warpgroup, S of tile t is issued with P·V of
// tile t − 1 and the softmax of t runs while that P·V is in flight; the
// two warpgroups take ping-pong turns, so one's softmax runs beside the
// other's products. The epilogue writes o = acc · (1/l) through the
// warpgroup's own rows of the q buffer with 16-byte stores, lse from the
// fragment, and hands the buffer back to the producer.
#include "flash_common.cuh"

using namespace apex_flash;

namespace {

// byte offsets from the aligned shared-memory base. Keys a k/v tile: 128
// where registers allow (D <= 64 without options), else 64.
template <int D, bool OPTS> struct FwdSmem {
  static constexpr int BN = D <= 64 && !OPTS ? 128 : 64;
  static constexpr int TB = BN * D * 2;           // one k or v tile
  static constexpr int TQ = BM * D * 2;           // q tile n at (n % 2)·TQ
  static constexpr int RING = 2 * TQ;             // stage s at RING + 2s·TB
  static constexpr int EXTRA = RING + NS * 2 * TB;  // f32 bias, u32 hash
  static constexpr int BAR = EXTRA + NS * BN * 8;  // q full/empty, the ring
  static constexpr size_t bytes = BAR + 8 * (4 + 2 * NS) + 1024;
};

template <typename T, int D, bool OPTS>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd(const __grid_constant__ FlashArgs a,
              const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv) {
  using L = FwdSmem<D, OPTS>;
  constexpr int BN = L::BN;
  unsigned char* sm = smem_base();
  const uint32_t s0 = smem_u32(sm);
  float* sBias = reinterpret_cast<float*>(sm + L::EXTRA);
  unsigned* sHc = reinterpret_cast<unsigned*>(sm + L::EXTRA + NS * BN * 4);
  // q buffer b: full at q_bar + 8b, empty at q_bar + 16 + 8b
  const uint32_t q_bar = s0 + L::BAR, bars = q_bar + 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0)
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_bar + 8 * b, 1);
      mbar_init(q_bar + 16 + 8 * b, NCONS * 128);
    }
  init_barriers(0, bars);

  // Work item w: q tile w % nqt of head w / nqt; block i takes items i,
  // i + gridDim.x, ... (the q tiles of a head run side by side and share
  // its k/v tiles in L2). g counts the ring's tiles over the items.
  const int nqt = (a.Sq + BM - 1) / BM, items = nqt * a.B * a.H;
  auto tiles = [&](const Head& hd, int q0) {
    // keys past the causal frontier of the tile's last row are all masked
    int k_end = a.Sk;
    if (OPTS && a.causal) k_end = min(k_end, min(q0 + BM, a.Sq) + hd.off);
    return k_end > 0 ? (k_end + BN - 1) / BN : 0;
  };

  if (warp == PRODUCER_WARP) {
    // the next item's q tile and first k/v tiles load while the consumers
    // finish this one
    int g = 0;
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const int bh = w / nqt, q0 = (w % nqt) * BM, qb = n & 1;
      const Head hd = head_of(a, bh);
      const int nt = tiles(hd, q0);
      mbar_wait(q_bar + 16 + 8 * qb, ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(q_bar + 8 * qb, L::TQ);
        tma_tile<D>(s0 + qb * L::TQ, &tq, q_bar + 8 * qb, BM, q0, hd.h,
                    hd.b);
      }
      produce_kv<D, OPTS, BN>(a, hd, &tk, &tv, s0 + L::RING, bars, sBias,
                              sHc, nt, g);
      g += nt;
    }
    return;
  }

  // a consumer warpgroup: q rows q0 + 64·wg + [0, 64) of each item
  const int wg = warp / 4, quad = lane % 4;
  const int rl = 64 * wg + 16 * (warp % 4) + lane / 4;   // row of half 0
  float o[D / 2], s[BN / 2];
  float m[2], l[2], alpha[2];
  uint32_t pa[BN / 16][4];                  // P of the tile before, in T
  // Ping-pong turns (flash_common.cuh) run on across items: both
  // warpgroups take the same turns in each, so warpgroup 1 passes once
  // before the first and warpgroup 0 waits once after the last.
  if (wg == 1) turn_pass(wg);
  int g = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int bh = w / nqt, q0 = (w % nqt) * BM, qb = n & 1;
    const Head hd = head_of(a, bh);
    const int nt = tiles(hd, q0);
    const uint32_t sq = s0 + qb * L::TQ;
    const int rows[2] = {q0 + rl, q0 + rl + 8};
    unsigned hr[2] = {0u, 0u};
    if (OPTS && a.seed)
      for (int hh = 0; hh < 2; ++hh) hr[hh] = row_hash(a, hd, rows[hh]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    // S = Q·Kᵀ of the item's tile t, issued (not waited for)
    auto issue_s = [&](int t) {
      const uint32_t sk = s0 + L::RING + 2 * ((g + t) % NS) * L::TB;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, BN>::ss(s, desc_k<D>(sq, BM, 64 * wg, kk),
                         desc_k<D>(sk, BN, 0, kk), kk > 0);
      wgmma_commit();
    };
    // O += P·V of tile t, P from pa, issued
    auto issue_pv = [&](int t) {
      const uint32_t sv = s0 + L::RING + 2 * ((g + t) % NS) * L::TB + L::TB;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Wgmma<T, D>::rs(o, pa[kk], desc_mn<D>(sv, BN, kk), 1);
      wgmma_commit();
    };
    auto full = [&](int t) {
      mbar_wait(bar_full(bars, (g + t) % NS), ((g + t) / NS) & 1);
    };
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(bar_empty(bars, (g + t) % NS));
    };
    // Tile t's scores in s: scale, bias and mask, then the online softmax:
    // s becomes the (dropped) p, m and l move on and alpha is O's rescale.
    // A row with no key yet keeps m = -inf and takes its exponents against
    // 0 (p = 0). Without options a tile inside Sk needs only the scale
    // (rows past Sq are never stored).
    auto softmax = [&](int t) {
      const int st = (g + t) % NS, k0 = t * BN;
      const bool plain = !OPTS && k0 + BN <= a.Sk;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * quad + e, i = 4 * j + 2 * hh + e;
            s[i] = plain ? s[i] * a.scale
                         : score<OPTS>(a, hd, s[i], rows[hh], k0 + cl,
                                       OPTS ? sBias[st * BN + cl] : 0.f);
            mx[hh] = fmaxf(mx[hh], s[i]);
          }
      float mul[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        mul[hh] = (m_new == -INFINITY ? 0.f : m_new) * LOG2E;
        alpha[hh] = m[hh] == m_new ? 1.f : exp_diff(m[hh], mul[hh]);
        m[hh] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * quad + e, i = 4 * j + 2 * hh + e;
            float p = exp_diff(s[i], mul[hh]);
            sum[hh] += p;                   // l sums the undropped p
            if (OPTS && a.seed)
              p = keep(a, hr[hh] + sHc[st * BN + cl]) ? p * a.drop_scale
                                                       : 0.f;
            s[i] = p;
          }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] = l[hh] * alpha[hh] + quad_sum(sum[hh]);
    };

    // One warpgroup's softmax runs while the other's products hold the
    // tensor cores. Both warpgroups compute every tile up to the block's
    // causal frontier (a tile all masked for warpgroup 0's rows leaves its
    // O and l as they are), so their turns pair up. Their turns: S of tile
    // 0, then S of tile t with P·V of tile t - 1, then the last P·V; tile
    // t's softmax runs while tile t - 1's P·V is in flight, and O is
    // rescaled once it lands.
    mbar_wait(q_bar + 8 * qb, (n >> 1) & 1);
    if (nt > 0) {                           // tile 0: nothing in flight
      full(0);
      turn_wait(wg);
      wgmma_fence();
      issue_s(0);
      turn_pass(wg);
      wgmma_wait0();
      fence_regs(s);
      softmax(0);                           // O is 0: no rescale
      frag_to_a<T, BN / 2>(pa, s);
    }
    // no branch between a product's issue and its wait, so ptxas need not
    // guess which are in flight
    for (int t = 1; t < nt; ++t) {
      full(t);
      fence_regs(s);
      fence_regs(o);
      turn_wait(wg);
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      turn_pass(wg);
      wgmma_wait1();                        // S landed, P·V may not have
      fence_regs(s);
      softmax(t);
      wgmma_wait0();
      fence_regs(o);
      release(t - 1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i / 2];
      frag_to_a<T, BN / 2>(pa, s);          // P in v's dtype
    }
    if (nt > 0) {
      fence_regs(o);
      turn_wait(wg);
      wgmma_fence();
      issue_pv(nt - 1);
      turn_pass(wg);
      wgmma_wait0();
      fence_regs(o);
      release(nt - 1);
    }

    // epilogue: o = acc · (1/l); a row that saw no key (l = 0) gives o = 0
    // and lse = NEG_INF. The warpgroup's rows of the q buffer stage o, and
    // the buffer goes back to the producer.
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                          l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[4 * j + i] *= inv[i / 2];
    unsigned char* stage = sm + qb * L::TQ + 64 * wg * Geo<D>::SW;
    wg_sync(wg);                            // every warp's products done
    frag_to_stage<T, D>(stage, BM * Geo<D>::SW, o);
    wg_sync(wg);
    stage_to_global<D>(stage, BM * Geo<D>::SW,
                       static_cast<T*>(a.o) + hd.b * a.o_bs + hd.h * D,
                       a.o_rs, q0 + 64 * wg, a.Sq);
    fence_proxy_async();                    // before TMA rewrites it
    mbar_arrive(q_bar + 16 + 8 * qb);
    if (quad == 0)
      for (int hh = 0; hh < 2; ++hh)
        if (rows[hh] < a.Sq)
          a.lse[(long long)bh * a.Sq + rows[hh]] =
              l[hh] > 0.f ? m[hh] + logf(l[hh]) : NEG_INF;
    g += nt;
  }
  if (wg == 0) turn_wait(wg);               // warpgroup 1's last pass
}

template <typename T, int D, bool OPTS>
int launch_opts(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_map<T, D>(&tq, a.q, a.q_bs, a.q_rs, a.H, a.Sq, a.B);
  if (!err) err = encode_map<T, D>(&tk, a.k, a.k_bs, a.k_rs, a.H, a.Sk, a.B);
  if (!err) err = encode_map<T, D>(&tv, a.v, a.v_bs, a.v_rs, a.H, a.Sk, a.B);
  if (err) return err;
  constexpr size_t smem = FwdSmem<D, OPTS>::bytes;
  err = smem_optin((const void*)flash_fwd<T, D, OPTS>, smem);
  if (err) return err;
  // one block an SM (registers allow no second), each taking items in turn
  int sms = 0;
  err = sm_count(&sms);
  if (err) return err;
  const int items = (a.Sq + BM - 1) / BM * a.B * a.H;
  flash_fwd<T, D, OPTS><<<min(items, sms), NTHREADS, smem, stream>>>(a, tq, tk,
                                                                    tv);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  return a.bias || a.causal || a.seed ? launch_opts<T, D, true>(a, stream)
                                      : launch_opts<T, D, false>(a, stream);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16; d: 32, 64 or 128. Returns a cudaError_t
// (0 = launched) or one of flash_common.cuh's ERR_* codes.
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
