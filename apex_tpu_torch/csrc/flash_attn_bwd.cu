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
// Two kernels recompute s, dP and the mask: 7 products, 60 GFLOP.
//
// Design (flash_common.cuh has the parts). Determinism without atomics:
// each work item's outputs belong to one block, which sums them in a fixed
// order, so the result is bit-for-bit repeatable; the price is that both
// kernels recompute s, dP and the dropout mask. Both kernels are
// persistent: one block an SM takes items in turn, and the producer loads
// the next item's resident tiles (into the second of two buffers) and its
// first streamed tiles while the consumers finish the item before.
// - flash_bwd_dkv: items (128-key tile, batch·head). The producer loads
//   k and v once an item and streams BQ-row q and do tiles (64 rows; 32 at
//   D = 128) through a three-stage TMA ring, staging each tile's lse,
//   delta (read a tile ahead) and dropout row hash in shared memory; q
//   tiles wholly before the causal frontier are skipped. Each consumer
//   warpgroup owns 64 keys and computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (wgmma,
//   K-major operands), so the fragments' rows are keys and their columns
//   q rows (lse and delta are per column there, and the dropout hash takes
//   its row term from the column). P̃ᵀ and dSᵀ go to 16 bits in registers
//   as the A operands of dV += P̃ᵀ·dO and dK += dSᵀ·Q, with do and q
//   MN-major. At D = 128 the dK and dV accumulators alone are 128 of the
//   168 registers a thread, hence the narrower q tiles there (ptxas still
//   spills some and serialises those products).
// - flash_bwd_dq: items (128-row q tile, batch·head). The producer loads
//   q and do once an item and streams 64-key k/v tiles, with their per-key
//   bias (read a tile ahead) and dropout terms, up to the causal frontier.
//   Each consumer warpgroup owns 64 q rows: S = Q·Kᵀ and dP = dO·Vᵀ, dS in
//   registers as the A operand of dQ += dS·K with k MN-major.
// In both, the two warpgroups take ping-pong turns to issue their
// products, so one's elementwise work runs beside the other's products;
// exponentials are one FFMA and ex2.approx. Outputs go through the
// warpgroup's own rows of the resident buffer with 16-byte stores.
#include "flash_common.cuh"

using namespace apex_flash;

namespace {

constexpr int BK = 64;   // keys a streamed tile of the dQ kernel

// byte offsets from the aligned shared-memory base
template <int D> struct DkvSmem {
  // q rows a streamed tile: at D = 128 the dK and dV accumulators take 128
  // registers a thread, so the Sᵀ and dPᵀ tiles shrink
  static constexpr int BQ = D <= 64 ? 64 : 32;
  static constexpr int TK = BM * D * 2;           // a k or v tile
  // item n's k at (n % 2)·2·TK, its v TK after it
  static constexpr int TQ = BQ * D * 2;           // a q or do tile
  static constexpr int RING = 4 * TK;             // stage s at RING + 2s·TQ
  static constexpr int EXTRA = RING + NS * 2 * TQ;  // lse, delta, row hash
  static constexpr int BAR = EXTRA + NS * BQ * 12;  // k/v full, empty; ring
  static constexpr size_t bytes = BAR + 8 * (4 + 2 * NS) + 1024;
};
template <int D> struct DqSmem {
  static constexpr int TQ = BM * D * 2;           // a q or do tile
  // item n's q at (n % 2)·2·TQ, its do TQ after it
  static constexpr int TB = BK * D * 2;           // a k or v tile
  static constexpr int RING = 4 * TQ;             // stage s at RING + 2s·TB
  static constexpr int EXTRA = RING + NS * 2 * TB;  // f32 bias, u32 hash
  static constexpr int BAR = EXTRA + NS * BK * 8;  // q/do full, empty; ring
  static constexpr size_t bytes = BAR + 8 * (4 + 2 * NS) + 1024;
};

// Barriers of the two resident buffers at rb: full[b] at rb + 8b (the
// producer's transaction), empty[b] at rb + 16 + 8b (every consumer
// thread, once the epilogue has read its staged rows).
__device__ __forceinline__ void init_resident(uint32_t rb) {
  if (threadIdx.x == 0)
    for (int b = 0; b < 2; ++b) {
      mbar_init(rb + 8 * b, 1);
      mbar_init(rb + 16 + 8 * b, NCONS * 128);
    }
}

// dK, dV for (128-key tile, batch·head) work items: item w is key tile
// w % nkt of head w / nkt, block i takes items i, i + gridDim.x, ...
template <typename T, int D, bool OPTS>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv(const __grid_constant__ FlashArgs a,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo) {
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ;
  unsigned char* sm = smem_base();
  const uint32_t s0 = smem_u32(sm);
  float* sLse = reinterpret_cast<float*>(sm + L::EXTRA);
  float* sDelta = sLse + NS * BQ;
  unsigned* sHr = reinterpret_cast<unsigned*>(sDelta + NS * BQ);
  const uint32_t rb = s0 + L::BAR, bars = rb + 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_resident(rb);
  init_barriers(0, bars);

  const int nkt = (a.Sk + BM - 1) / BM, items = nkt * a.B * a.H;
  const int nq = (a.Sq + BQ - 1) / BQ;
  // q tiles whose rows are all before the frontier of key k0 are skipped:
  // they form a prefix
  auto first_tile = [&](const Head& hd, int k0) {
    int qt0 = 0;
    if (OPTS && a.causal)
      while (qt0 < nq && min((qt0 + 1) * BQ, a.Sq) - 1 + hd.off < k0) ++qt0;
    return qt0;
  };

  if (warp == PRODUCER_WARP) {
    int g = 0;
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const int bh = w / nkt, k0 = (w % nkt) * BM, b = n & 1;
      const Head hd = head_of(a, bh);
      const int qt0 = first_tile(hd, k0), nt = nq - qt0;
      mbar_wait(rb + 16 + 8 * b, ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t kv = s0 + b * 2 * L::TK;
        mbar_arrive_tx(rb + 8 * b, 2 * L::TK);
        tma_tile<D>(kv, &tk, rb + 8 * b, BM, k0, hd.h, hd.b);
        tma_tile<D>(kv + L::TK, &tv, rb + 8 * b, BM, k0, hd.h, hd.b);
      }
      const float* lse = a.lse + (long long)bh * a.Sq;
      const float* delta = a.delta + (long long)bh * a.Sq;
      // a tile's lse and delta are read a tile ahead, so their latency
      // passes while the producer waits for a free stage; rows past Sq
      // load 0
      constexpr int PER = BQ / 32;
      float nl[PER], nd[PER];
      auto fetch = [&](int t) {
        const int q0 = (qt0 + t) * BQ;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int q = q0 + lane + 32 * j;
          const bool in = t < nt && q < a.Sq;
          nl[j] = in ? lse[q] : 0.f;
          nd[j] = in ? delta[q] : 0.f;
        }
      };
      fetch(0);
      for (int t = 0; t < nt; ++t) {
        const int s = (g + t) % NS, q0 = (qt0 + t) * BQ;
        mbar_wait(bar_empty(bars, s), (((g + t) / NS) & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int i = lane + 32 * j;
          sLse[s * BQ + i] = nl[j] * LOG2E;   // as exp_diff takes it
          sDelta[s * BQ + i] = nd[j];
          if (OPTS && a.seed) sHr[s * BQ + i] = row_hash(a, hd, q0 + i);
        }
        fetch(t + 1);
        if (lane == 0) {
          const uint32_t dst = s0 + L::RING + 2 * s * L::TQ;
          const uint32_t full = bar_full(bars, s);
          mbar_arrive_tx(full, 2 * L::TQ);
          tma_tile<D>(dst, &tq, full, BQ, q0, hd.h, hd.b);
          tma_tile<D>(dst + L::TQ, &tdo, full, BQ, q0, hd.h, hd.b);
        } else {
          mbar_arrive(bar_full(bars, s));
        }
      }
      g += nt;
    }
    return;
  }

  // a consumer warpgroup: keys k0 + 64·wg + [0, 64) of each item, the
  // fragments' rows. Two ping-pong turns a tile (flash_common.cuh): Sᵀ
  // and dPᵀ, then dV and dK; a tile the warpgroup skips still takes its
  // turns, and the turns run on across items.
  const int wg = warp / 4, quad = lane % 4;
  const int kl = 64 * wg + 16 * (warp % 4) + lane / 4;
  float dk[D / 2], dv[D / 2], st[BQ / 2], dp[BQ / 2];
  if (wg == 1) turn_pass(wg);
  int g = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int bh = w / nkt, k0 = (w % nkt) * BM, b = n & 1;
    const Head hd = head_of(a, bh);
    const int qt0 = first_tile(hd, k0), nt = nq - qt0;
    const uint32_t sk = s0 + b * 2 * L::TK, sv = sk + L::TK;
    const int keys[2] = {k0 + kl, k0 + kl + 8};
    float kb[2] = {0.f, 0.f};
    unsigned kh[2] = {0u, 0u};
    if (OPTS)
      for (int hh = 0; hh < 2; ++hh) {
        kb[hh] = col_bias(a, hd, keys[hh]);
        if (a.seed) kh[hh] = col_hash(a, hd, keys[hh]);
      }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(rb + 8 * b, (n >> 1) & 1);

    for (int t = 0; t < nt; ++t) {
      const int s = (g + t) % NS, q0 = (qt0 + t) * BQ;
      mbar_wait(bar_full(bars, s), ((g + t) / NS) & 1);
      // every row of this q tile is before the frontier of this
      // warpgroup's first key
      if (OPTS && a.causal
          && min(q0 + BQ, a.Sq) - 1 + hd.off < k0 + 64 * wg) {
        for (int i = 0; i < 2; ++i) {
          turn_wait(wg);
          turn_pass(wg);
        }
      } else {
        const uint32_t sq = s0 + L::RING + 2 * s * L::TQ, sdo = sq + L::TQ;
        // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T, BQ>::ss(st, desc_k<D>(sk, BM, 64 * wg, kk),
                           desc_k<D>(sq, BQ, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T, BQ>::ss(dp, desc_k<D>(sv, BM, 64 * wg, kk),
                           desc_k<D>(sdo, BQ, 0, kk), kk > 0);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait0();
        fence_regs(st);
        fence_regs(dp);

        // P̃ᵀ into st, dSᵀ into dp; masked elements score -inf: p = 0.
        // Without options a tile inside Sq and Sk needs only the scale.
        const bool plain = !OPTS && q0 + BQ <= a.Sq && k0 + BM <= a.Sk;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 8 * j + 2 * quad + e, i = 4 * j + 2 * hh + e;
              const float p = exp_diff(
                  plain ? st[i] * a.scale
                        : score<OPTS>(a, hd, st[i], q0 + cl, keys[hh],
                                      kb[hh]),
                  sLse[s * BQ + cl]);
              float dpv = dp[i], pv = p;
              if (OPTS && a.seed) {
                if (keep(a, sHr[s * BQ + cl] + kh[hh])) {
                  pv = p * a.drop_scale;
                  dpv *= a.drop_scale;
                } else {
                  pv = dpv = 0.f;
                }
              }
              st[i] = pv;
              dp[i] = p * (dpv - sDelta[s * BQ + cl]);
            }
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        frag_to_a<T, BQ / 2>(pa, st);
        frag_to_a<T, BQ / 2>(da, dp);

        // dV += P̃ᵀ·dO, dK += dSᵀ·Q (contraction over the tile's q rows)
        fence_regs(dv);
        fence_regs(dk);
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<T, D>::rs(dv, pa[kk], desc_mn<D>(sdo, BQ, kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<T, D>::rs(dk, da[kk], desc_mn<D>(sq, BQ, kk), 1);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait0();
        fence_regs(dv);
        fence_regs(dk);
      }
      if (lane == 0) mbar_arrive(bar_empty(bars, s));
    }

    // epilogue: the warpgroup's own rows of the k and v buffers stage dK
    // (times scale) and dV, and the buffers go back to the producer
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] *= a.scale;
    const int off = 64 * wg * Geo<D>::SW, stride = BM * Geo<D>::SW;
    unsigned char* kst = sm + b * 2 * L::TK + off;
    wg_sync(wg);                            // every warp's products done
    frag_to_stage<T, D>(kst, stride, dk);
    frag_to_stage<T, D>(kst + L::TK, stride, dv);
    wg_sync(wg);
    const long long base = hd.b * a.dkv_bs + hd.h * D;
    stage_to_global<D>(kst, stride, static_cast<T*>(a.dk) + base, a.dkv_rs,
                       k0 + 64 * wg, a.Sk);
    stage_to_global<D>(kst + L::TK, stride, static_cast<T*>(a.dv) + base,
                       a.dkv_rs, k0 + 64 * wg, a.Sk);
    fence_proxy_async();                    // before TMA rewrites them
    mbar_arrive(rb + 16 + 8 * b);
    g += nt;
  }
  if (wg == 0) turn_wait(wg);               // warpgroup 1's last pass
}

// dQ for (128-row q tile, batch·head) work items: item w is q tile
// w % nqt of head w / nqt, block i takes items i, i + gridDim.x, ...
template <typename T, int D, bool OPTS>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq(const __grid_constant__ FlashArgs a,
                 const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo) {
  using L = DqSmem<D>;
  unsigned char* sm = smem_base();
  const uint32_t s0 = smem_u32(sm);
  float* sBias = reinterpret_cast<float*>(sm + L::EXTRA);
  unsigned* sHc = reinterpret_cast<unsigned*>(sm + L::EXTRA + NS * BK * 4);
  const uint32_t rb = s0 + L::BAR, bars = rb + 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_resident(rb);
  init_barriers(0, bars);

  const int nqt = (a.Sq + BM - 1) / BM, items = nqt * a.B * a.H;
  auto tiles = [&](const Head& hd, int q0) {
    int k_end = a.Sk;
    if (OPTS && a.causal) k_end = min(k_end, min(q0 + BM, a.Sq) + hd.off);
    return k_end > 0 ? (k_end + BK - 1) / BK : 0;
  };

  if (warp == PRODUCER_WARP) {
    int g = 0;
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const int bh = w / nqt, q0 = (w % nqt) * BM, b = n & 1;
      const Head hd = head_of(a, bh);
      const int nt = tiles(hd, q0);
      mbar_wait(rb + 16 + 8 * b, ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t qd = s0 + b * 2 * L::TQ;
        mbar_arrive_tx(rb + 8 * b, 2 * L::TQ);
        tma_tile<D>(qd, &tq, rb + 8 * b, BM, q0, hd.h, hd.b);
        tma_tile<D>(qd + L::TQ, &tdo, rb + 8 * b, BM, q0, hd.h, hd.b);
      }
      produce_kv<D, OPTS, BK>(a, hd, &tk, &tv, s0 + L::RING, bars, sBias,
                              sHc, nt, g);
      g += nt;
    }
    return;
  }

  // a consumer warpgroup: q rows q0 + 64·wg + [0, 64) of each item. Two
  // ping-pong turns a tile (flash_common.cuh): S and dP, then dQ; a tile
  // the warpgroup skips still takes its turns, and the turns run on
  // across items.
  const int wg = warp / 4, quad = lane % 4;
  const int rl = 64 * wg + 16 * (warp % 4) + lane / 4;
  float dq[D / 2], sc[BK / 2], dp[BK / 2];
  if (wg == 1) turn_pass(wg);
  int g = 0;
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const int bh = w / nqt, q0 = (w % nqt) * BM, b = n & 1;
    const Head hd = head_of(a, bh);
    const int nt = tiles(hd, q0);
    const uint32_t sq = s0 + b * 2 * L::TQ, sdo = sq + L::TQ;
    const int rows[2] = {q0 + rl, q0 + rl + 8};
    const int wg_last = min(q0 + 64 * wg + 63, a.Sq - 1);
    float lse_l2[2], delta_r[2];
    unsigned hr[2] = {0u, 0u};
    for (int hh = 0; hh < 2; ++hh) {
      const bool in = rows[hh] < a.Sq;      // rows past Sq load 0
      lse_l2[hh] = in ? a.lse[(long long)bh * a.Sq + rows[hh]] * LOG2E : 0.f;
      delta_r[hh] = in ? a.delta[(long long)bh * a.Sq + rows[hh]] : 0.f;
      if (OPTS && a.seed) hr[hh] = row_hash(a, hd, rows[hh]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(rb + 8 * b, (n >> 1) & 1);

    for (int t = 0; t < nt; ++t) {
      const int s = (g + t) % NS, k0 = t * BK;
      mbar_wait(bar_full(bars, s), ((g + t) / NS) & 1);
      if (OPTS && a.causal && k0 > wg_last + hd.off) {
        for (int i = 0; i < 2; ++i) {
          turn_wait(wg);
          turn_pass(wg);
        }
      } else {
        const uint32_t sk = s0 + L::RING + 2 * s * L::TB, sv = sk + L::TB;
        // S = Q·Kᵀ, dP = dO·Vᵀ
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T, BK>::ss(sc, desc_k<D>(sq, BM, 64 * wg, kk),
                           desc_k<D>(sk, BK, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T, BK>::ss(dp, desc_k<D>(sdo, BM, 64 * wg, kk),
                           desc_k<D>(sv, BK, 0, kk), kk > 0);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);

        // dS into dp; without options a tile inside Sq and Sk needs only
        // the scale
        const bool plain = !OPTS && q0 + BM <= a.Sq && k0 + BK <= a.Sk;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 8 * j + 2 * quad + e, i = 4 * j + 2 * hh + e;
              const float p = exp_diff(
                  plain ? sc[i] * a.scale
                        : score<OPTS>(a, hd, sc[i], rows[hh], k0 + cl,
                                      OPTS ? sBias[s * BK + cl] : 0.f),
                  lse_l2[hh]);
              float dpv = dp[i];
              if (OPTS && a.seed)
                dpv = keep(a, hr[hh] + sHc[s * BK + cl]) ? dpv * a.drop_scale
                                                          : 0.f;
              dp[i] = p * (dpv - delta_r[hh]);
            }
        uint32_t da[BK / 16][4];
        frag_to_a<T, BK / 2>(da, dp);

        // dQ += dS·K (contraction over the tile's keys)
        fence_regs(dq);
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<T, D>::rs(dq, da[kk], desc_mn<D>(sk, BK, kk), 1);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait0();
        fence_regs(dq);
      }
      if (lane == 0) mbar_arrive(bar_empty(bars, s));
    }

    // epilogue: the warpgroup's own rows of the q buffer stage dQ·scale,
    // and the buffers go back to the producer
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] *= a.scale;
    unsigned char* stage = sm + b * 2 * L::TQ + 64 * wg * Geo<D>::SW;
    wg_sync(wg);                            // every warp's products done
    frag_to_stage<T, D>(stage, BM * Geo<D>::SW, dq);
    wg_sync(wg);
    stage_to_global<D>(stage, BM * Geo<D>::SW,
                       static_cast<T*>(a.dq) + hd.b * a.dq_bs + hd.h * D,
                       a.dq_rs, q0 + 64 * wg, a.Sq);
    fence_proxy_async();                    // before TMA rewrites it
    mbar_arrive(rb + 16 + 8 * b);
    g += nt;
  }
  if (wg == 0) turn_wait(wg);               // warpgroup 1's last pass
}

template <typename T, int D, bool OPTS>
int launch_opts(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_map<T, D>(&tq, a.q, a.q_bs, a.q_rs, a.H, a.Sq, a.B);
  if (!err) err = encode_map<T, D>(&tk, a.k, a.k_bs, a.k_rs, a.H, a.Sk, a.B);
  if (!err) err = encode_map<T, D>(&tv, a.v, a.v_bs, a.v_rs, a.H, a.Sk, a.B);
  if (!err)
    err = encode_map<T, D>(&tdo, a.dout, a.do_bs, a.do_rs, a.H, a.Sq, a.B);
  if (err) return err;
  constexpr size_t smem_kv = DkvSmem<D>::bytes, smem_q = DqSmem<D>::bytes;
  err = smem_optin((const void*)flash_bwd_dkv<T, D, OPTS>, smem_kv);
  if (!err) err = smem_optin((const void*)flash_bwd_dq<T, D, OPTS>, smem_q);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  // one block an SM (registers allow no second), each taking items in turn
  const int kv_items = (a.Sk + BM - 1) / BM * a.B * a.H;
  const int q_items = (a.Sq + BM - 1) / BM * a.B * a.H;
  flash_bwd_dkv<T, D, OPTS><<<min(kv_items, sms), NTHREADS, smem_kv,
                              stream>>>(a, tq, tk, tv, tdo);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq<T, D, OPTS><<<min(q_items, sms), NTHREADS, smem_q, stream>>>(
      a, tq, tk, tv, tdo);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  return a.bias || a.causal || a.seed ? launch_opts<T, D, true>(a, stream)
                                      : launch_opts<T, D, false>(a, stream);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16; d: 32, 64 or 128. Returns a cudaError_t
// (0 = both kernels launched) or one of flash_common.cuh's ERR_* codes.
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
