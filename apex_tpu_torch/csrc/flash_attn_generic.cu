// Flash attention for Hopper (sm_90a) on the tensor cores by warp-level
// mma.sync: the forward and a two-kernel backward for every case the wgmma
// kernels (flash_attn_fwd.cu, flash_attn_bwd.cu) refuse: f32 q, k, v, and
// any head dim 1 <= D <= 256 in f32, bf16 or fp16, at any 16-bit or f32
// base address and row stride.
//
// Replaces, for those operands, apex_tpu/ops/attention.py::_fwd_kernel_nl
// and _fwd_kernel (the forward), _bwd_fused_kernel_nl, _bwd_dq_kernel_nl /
// _bwd_dkv_kernel_nl and _bwd_dq_kernel / _bwd_dkv_kernel (the backward).
// The JAX kernels pad D up to whole 128-lane rows and take f32; these
// kernels pad D only up to the MMA's depth (16 at 16 bits, 8 at f32) by
// zero-filled shared-memory columns and take the element type as a
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
// What bounds it on an H100. At 16 bits: the bytes at short sequences
// (ViT-H/14's S = 257 at D = 80 moves 42 MB against 5.4 GFLOP forward) and
// the tensor cores' 989 TFLOP/s beyond. At f32: the products, which run as
// three TF32 products each (below), so 3 × 4·B·H·S²·D FLOP forward at the
// 494.7 TFLOP/s TF32 rate, with the softmax's exponentials and the
// operands' splits on the CUDA cores beside them.
//
// Design. A block is four warps (128 threads); each warp owns one or two
// m16 row tiles of a 64- or 128-row resident tile (queries in the forward
// and dQ, keys in dK/dV) and streams the other operand's tiles of 16 or
// 32 rows through shared memory, loaded by cp.async (16 bytes a copy
// where the base, the strides and D allow it, else 8 or 4, else plain
// 2-byte loads; rows past S by the zero-fill form), so the next tile loads
// while this one multiplies. Every product is mma.sync with f32
// accumulators in registers:
// - 16 bits: m16n8k16 on a two-stage ring the products read directly,
//   fragments by ldmatrix (.trans for the operand read along its rows).
//   The probabilities (and dS) stay in registers: the accumulator
//   fragments of two n8 tiles are the A fragment of the next product's k16
//   step once rounded to the operand dtype, as in FlashAttention-2.
// - f32: m16n8k8.tf32 three times, x = hi + lo with hi = tf32(x) and
//   lo = tf32(x − hi), each rounded as cvt.rna.tf32.f32 rounds, as
//   hi·lo + lo·hi + hi·hi; the dropped lo·lo term is below 2⁻²² of the
//   product, so a sum keeps f32 accuracy (one TF32 product keeps about
//   three digits, which is another result). A split pass turns each staged
//   tile into its hi and lo parts once a block, not once a warp, and the
//   products read the parts by ldmatrix (an f32 as two b16) while the next
//   tile loads into the staging buffer; the resident tile is split at each
//   k step. An accumulator fragment holds columns (2t, 2t+1) where the k8 A
//   fragment wants (t, t + 4): the next product reads its B rows in the
//   same permuted order (keys 2t, 2t+1 for k positions t, t + 4), so P
//   needs no shuffle.
// The kernels are latency-bound (four warps a block, chains of mma.sync,
// the softmax's reductions), so the warps an SM and the work a warp has
// in flight set their speed: a deeper ring, the resident tile split once
// into shared memory, larger streamed tiles or dK/dV in slices each cost
// more in blocks an SM than they saved; two m16 tiles a warp (each B
// fragment and each split pass then serve twice the rows) pay for the
// block they cost in the f32 forward and dQ. Hence small streamed tiles
// and launch bounds that hold two to four blocks an SM where the shared
// memory allows it. Shared-memory rows are padded (8
// elements at 16 bits, 4 floats at f32) so ldmatrix's eight rows and the
// f32 fragments' 32 lanes hit distinct banks. Instances are templated on
// three width classes DP in {64, 128, 256}; within a class the count of k
// steps and of output n8 tiles is the runtime D's, so D = 80 pays for 80
// columns, not 128. At DP >= 128 the dK/dV kernel runs as two grid slices
// (blockIdx.z: dV, then dK, each recomputing P) so a thread holds one
// D-wide accumulator, not two. Determinism: no atomics; dQ and dK/dV come
// from two kernels that each recompute s, dP and the keep mask, and every
// sum runs in an order fixed by the shape, so the results repeat bit for
// bit. Tiles wholly past the causal frontier are skipped (they add exact
// zeros).
#include "flash_common.cuh"

using namespace apex_flash;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;   // rows of a resident tile

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

// Geometry by element type and width class DP (elements a row: LD for
// the tiles the MMAs read, LDR for the resident tiles, LDS for the staged
// ones; BN rows a streamed tile; NS stages of the staging ring).
// - 16 bits: the products read the staged tiles; NS = 2, so the next tile
//   loads while one multiplies.
// - f32: the products read hi and lo parts (uint32 tiles of LD) that a
//   split pass made from the staged tile; the next tile loads meanwhile.
//   The staged rows are read only by that pass, so they take no padding,
//   nor do the resident rows at DP = 256, where the padding would not fit.
// Measured on the H100 (f32 at D = 64, bf16 at D = 80;
// scripts/torch_kernel_variants.py): at f32, 16-row streamed tiles, two
// m16 tiles a warp in the forward (three blocks an SM) and in dQ (two),
// one in dK/dV (three); at 16 bits 32-row tiles, one m16 tile a warp, four
// blocks an SM in the forward and three in the backward.
template <typename T, int DP> struct Tiles {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int E = sizeof(T);
  static constexpr int LD = DP + (F32 ? 4 : 8);
  static constexpr int LDR = F32 && DP == 256 ? DP : LD;
  static constexpr int LDS = F32 ? DP : LD;
  static constexpr int BN = F32 ? 16 : 32;
  static constexpr int NS = F32 ? 1 : 2;
  // m16 tiles a warp in the forward and dQ (a resident tile is BM·MT
  // rows); dK/dV keeps one, as two cost it more in blocks an SM than they
  // saved
  static constexpr int MT = F32 && DP == 64 ? 2 : 1;
  // lse/delta slots (dK/dV): a tile's stay while the NS next ones load
  static constexpr int NL = F32 ? NS + 1 : NS;
  static constexpr int KS = F32 ? 8 : 16;           // depth of a k step
  static constexpr bool SPLIT = DP > 64;            // dK/dV in two slices
  // blocks an SM each kernel asks registers for (shared memory allows it)
  static constexpr int FWD_MINB = F32 ? (DP == 64 ? 3 : 1)
                                      : (DP <= 128 ? 4 : 1);
  static constexpr int DQ_MINB = F32 ? (DP == 64 ? (MT == 2 ? 2 : 3) : 1)
                                     : (DP <= 128 ? 3 : 1);
  static constexpr int DKV_MINB = F32 ? (DP == 64 ? 3 : 1)
                                      : (DP <= 128 ? 3 : 1);
  // the staging ring and the f32 parts, a streamed row
  static constexpr size_t ring_bytes = (size_t)E * NS * 2 * LDS;
  static constexpr size_t split_bytes = F32 ? 4 * 4 * (size_t)LD : 0;
  static constexpr size_t fwd_bytes =
      (size_t)E * BM * MT * LDR + (ring_bytes + split_bytes) * BN;
  static constexpr size_t dq_bytes =
      (size_t)E * 2 * BM * MT * LDR + (ring_bytes + split_bytes) * BN;
  static constexpr size_t dkv_bytes =
      (size_t)E * 2 * BM * LDR + (ring_bytes + split_bytes) * BN
      + sizeof(float) * 2 * NL * BN;
  static_assert(dkv_bytes <= 232448,
                "a block's shared memory is at most 227 KB");
};

// A streamed operand as the products read it: the staged 16-bit tile, or
// an f32 tile's TF32 hi and lo parts.
template <typename T> struct Tile {
  const T* p;
};
template <> struct Tile<float> {
  const uint32_t* hi;
  const uint32_t* lo;
};

// Bytes a copy of each operand's head rows may move: the largest of 16, 8
// and 4 (2 at 16 bits) that divides its base address, batch and row
// strides and D, so a row is whole copies.
struct Vecs {
  int q, k, v, dout;
};

// --- cp.async ---------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? BYTES : 0;  // the zero-fill form: n = 0 writes 0s
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 ::"r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 ::"r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a head plane `src` (row stride rs elements)
// into dst (row stride LD): D columns in copies of BYTES (2: plain loads
// and stores); rows at or past S are zeros.
template <typename T, int ROWS, int LD, int BYTES>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long rs,
                                          int row0, int S, int D) {
  constexpr int CE = BYTES / (int)sizeof(T);
  const int nch = D / CE;                 // copies a row
  const int dr = kThreads / nch, dc = kThreads % nch;
  int r = threadIdx.x / nch, ci = threadIdx.x % nch;
  for (; r < ROWS; r += dr, ci += dc) {
    if (ci >= nch) {
      ci -= nch;
      if (++r >= ROWS) break;
    }
    const int c = ci * CE, gr = row0 + r;
    const bool in = gr < S;
    const T* s = src + (in ? (long long)gr * rs + c : 0);
    T* d = dst + r * LD + c;
    if constexpr (BYTES >= 4) {
      cp_async<BYTES>(d, s, in);
    } else {
      *reinterpret_cast<unsigned short*>(d) =
          in ? *reinterpret_cast<const unsigned short*>(s) : 0;
    }
  }
}
template <typename T, int ROWS, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs,
                                          int row0, int S, int D, int vec) {
  if (vec == 16) {
    copy_rows<T, ROWS, LD, 16>(dst, src, rs, row0, S, D);
  } else if (vec == 8) {
    copy_rows<T, ROWS, LD, 8>(dst, src, rs, row0, S, D);
  } else {
    if constexpr (sizeof(T) == 4) {
      copy_rows<T, ROWS, LD, 4>(dst, src, rs, row0, S, D);
    } else {
      if (vec == 4) copy_rows<T, ROWS, LD, 4>(dst, src, rs, row0, S, D);
      else copy_rows<T, ROWS, LD, 2>(dst, src, rs, row0, S, D);
    }
  }
}

// Columns [D, D rounded up to R) of `rows` rows set to 0 once: the
// products (and the f32 split pass) read that far, no copy writes there,
// and zeros keep NaN and inf out of the padding.
template <typename T, int LD, int R>
__device__ __forceinline__ void zero_pad(T* dst, int rows, int D) {
  const int w = ((D + R - 1) / R) * R - D;
  if (w == 0) return;
  for (int i = threadIdx.x; i < rows * w; i += kThreads) {
    const int r = i / w;
    dst[r * LD + D + (i - r * w)] = from_f<T>(0.f);
  }
}

// --- warp MMA ---------------------------------------------------------------

// ldmatrix.x4: lanes 8m .. 8m + 7 address the eight 16-byte rows of matrix
// m; lane 4g + t receives 32 bits at (row g, bytes 4t .. 4t + 3) of each.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a·b, m16n8k16, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b, m16n8k8 on TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): its own arithmetic, half a TF32 ulp added to the bits and
// the 13 low bits cleared, without its guard for inf and NaN. Two
// instructions, not three. An inf stays inf; a NaN x may round to another
// value, but then lo = x − hi is NaN, so the product is NaN as with cvt.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo: hi = tf32(x), lo = tf32(x − hi) (x − hi is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// d += a·b in f32 accuracy as three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Rows [0, ROWS) x columns [0, 4·n4) of a staged f32 tile (row stride LDS)
// into its hi and lo tiles (row stride LD), four elements a thread a turn.
template <int ROWS, int LDS, int LD>
__device__ __forceinline__ void split_rows(const float* src, uint32_t* hi,
                                           uint32_t* lo, int n4) {
  const int dr = kThreads / n4, dc = kThreads % n4;
  int r = threadIdx.x / n4, c = threadIdx.x % n4;
  for (; r < ROWS; r += dr, c += dc) {
    if (c >= n4) {
      c -= n4;
      if (++r >= ROWS) break;
    }
    const float4 x = *reinterpret_cast<const float4*>(src + r * LDS + 4 * c);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * LD + 4 * c) = h;
    *reinterpret_cast<uint4*>(lo + r * LD + 4 * c) = l;
  }
}

// The accumulator fragment of an m16n8 tile: lane = 4g + t holds element i
// at row g + 8·(i / 2), column 2t + i % 2. A k step loads its fragments
// before issuing its MMAs.

// acc[mt] = X[r0 + 16mt, r0 + 16mt + 16) · Y[0, 8·NT)ᵀ over the first nk
// k steps of the rows, for the MT m16 tiles of a warp: X a resident tile
// (row stride LDX), Y a streamed one, the contraction along the rows; each
// B fragment serves every m tile. The k loop stays a loop: unrolled whole,
// the kernels outgrow the instruction cache (8% slower at f32, D = 64).
template <typename T, int MT, int NT, int LDX, int LD>
__device__ __forceinline__ void mm_nt(float (&acc)[MT][NT][4], const T* X,
                                      const Tile<T> Y, int r0, int nk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  if constexpr (sizeof(T) == 2) {
    const T* xa = X + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX
                  + (lane >> 4) * 8;
    const T* yb = Y.p + ((lane & 7) + (lane >> 4) * 8) * LD
                  + ((lane >> 3) & 1) * 8;
#pragma unroll 1
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm4(a[mt], xa + mt * 16 * LDX + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp)
        ldsm4(b[jp], yb + jp * 16 * LD + kk * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          mma16<T>(acc[mt][2 * jp], a[mt], b[jp][0], b[jp][1]);
          mma16<T>(acc[mt][2 * jp + 1], a[mt], b[jp][2], b[jp][3]);
        }
    }
  } else {
    // the 32-bit fragments by ldmatrix: an 8 x 8 b16 matrix is 8 rows of
    // four f32, so A's four matrices are (rows 0-7 | 8-15) x (k 0-3 | 4-7)
    // and a pair of B's n8 tiles (n 0-7 | 8-15) x (k 0-3 | 4-7)
    const float* xa = X + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX
                      + (lane >> 4) * 4;
    const int yo = ((lane & 7) + (lane >> 4) * 8) * LD
                   + ((lane >> 3) & 1) * 4;
#pragma unroll 4   // four k steps a turn: a 6% faster f32 backward than one
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t ah[MT][4], al[MT][4], bh[NT / 2][4], bl[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm4(ah[mt], xa + mt * 16 * LDX + kk * 8);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        ldsm4(bh[jp], Y.hi + yo + jp * 16 * LD + kk * 8);
        ldsm4(bl[jp], Y.lo + yo + jp * 16 * LD + kk * 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(__uint_as_float(ah[mt][i]), ah[mt][i], al[mt][i]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          mma3(acc[mt][2 * jp], ah[mt], al[mt], bh[jp][0], bh[jp][1],
               bl[jp][0], bl[jp][1]);
          mma3(acc[mt][2 * jp + 1], ah[mt], al[mt], bh[jp][2], bh[jp][3],
               bl[jp][2], bl[jp][3]);
        }
    }
  }
}

// out[mt] += P[mt] · Y: P[mt] is m tile mt's 16 x 8·NT accumulator tiles
// (rounded to T at 16 bits), Y a streamed tile's rows [0, 8·NT) (the
// contraction) by columns [0, 8·nd) of the ND n8 tiles out holds. A k
// step's loads go in groups of at most eight n8 tiles, each group's loads
// before its MMAs, and serve every m tile.
template <typename T, int MT, int NT, int ND, int LD>
__device__ __forceinline__ void mm_pv(float (&out)[MT][ND][4],
                                      const float (&p)[MT][NT][4],
                                      const Tile<T> Y, int nd) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    constexpr int GP = ND / 2 < 4 ? ND / 2 : 4;   // n8 pairs a group
    const T* yb = Y.p + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD
                  + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack2<T>(p[mt][2 * kk][0], p[mt][2 * kk][1]);
        a[mt][1] = pack2<T>(p[mt][2 * kk][2], p[mt][2 * kk][3]);
        a[mt][2] = pack2<T>(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
        a[mt][3] = pack2<T>(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int g0 = 0; g0 < ND / 2; g0 += GP) {
        if (2 * g0 < nd) {
          uint32_t b[GP][4];
#pragma unroll
          for (int q = 0; q < GP; ++q)
            if (2 * (g0 + q) < nd)
              ldsm4t(b[q], yb + kk * 16 * LD + (g0 + q) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int q = 0; q < GP; ++q)
              if (2 * (g0 + q) < nd) {
                mma16<T>(out[mt][2 * (g0 + q)], a[mt], b[q][0], b[q][1]);
                mma16<T>(out[mt][2 * (g0 + q) + 1], a[mt], b[q][2], b[q][3]);
              }
        }
      }
    }
  } else {
    // k positions (t, t + 4) of step kk are keys 8kk + 2t, 8kk + 2t + 1:
    // the accumulator's own columns, so P needs no shuffle
    constexpr int GT = ND < 8 ? ND : 8;           // n8 tiles a group
    const int g = lane >> 2, t = lane & 3;
    const int yo = 2 * t * LD + g;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(p[mt][kk][0], ah[mt][0], al[mt][0]);
        split(p[mt][kk][2], ah[mt][1], al[mt][1]);
        split(p[mt][kk][1], ah[mt][2], al[mt][2]);
        split(p[mt][kk][3], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int g0 = 0; g0 < ND; g0 += GT) {
        if (g0 < nd) {
          uint32_t b[GT][4];
#pragma unroll
          for (int q = 0; q < GT; ++q)
            if (g0 + q < nd) {
              const int o = yo + kk * 8 * LD + (g0 + q) * 8;
              b[q][0] = Y.hi[o];
              b[q][1] = Y.hi[o + LD];
              b[q][2] = Y.lo[o];
              b[q][3] = Y.lo[o + LD];
            }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int q = 0; q < GT; ++q)
              if (g0 + q < nd)
                mma3(out[mt][g0 + q], ah[mt], al[mt], b[q][0], b[q][1],
                     b[q][2], b[q][3]);
        }
      }
    }
  }
}

// Rows [r0, r0 + 16·MT) of acc·mul (m tile mt at r0 + 16mt) to a (rows,
// D) head plane (row stride rs): rows at or past S and columns at or past
// D skipped.
template <typename T, int MT, int ND>
__device__ __forceinline__ void store_rows(T* dst, long long rs,
                                           const float (&acc)[MT][ND][4],
                                           float mul, int r0, int S, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 16 * mt + g + 8 * hh;
      if (r >= S) continue;
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * j + 2 * t + e;
          if (d < D)
            dst[r * rs + d] = from_f<T>(acc[mt][j][2 * hh + e] * mul);
        }
    }
}

// The streamed loop over nt tiles: issue(it) stages tile it (and commits
// one cp.async group), split(it) makes an f32 tile's hi and lo parts,
// body(it) runs its products. Every turn commits one group (empty past the
// last tile), so a fixed wait count finds tile it landed.
// - 16 bits: tiles it + 1 and it + 2 load while tile it multiplies; the
//   stage tile it + 2 fills is the one tile it − 1 left.
// - f32: tile it's split pass reads its stage, then that stage takes tile
//   it + NS while tile it multiplies from its parts.
template <typename G, typename Issue, typename Split, typename Body>
__device__ __forceinline__ void stream(int nt, Issue issue, Split split,
                                       Body body) {
  constexpr int AHEAD = G::F32 ? G::NS : G::NS - 1;
  auto next = [&](int it) {
    if (it < nt) issue(it);
    else cp_commit();
  };
  for (int i = 0; i < AHEAD; ++i) next(i);
  for (int it = 0; it < nt; ++it) {
    if constexpr (G::F32) {
      cp_wait<G::NS - 1>();
      __syncthreads();     // tile it staged; tile it − 1's products done
      split(it);
      __syncthreads();     // the parts ready, the stage free
      next(it + G::NS);
      body(it);
    } else {
      next(it + G::NS - 1);
      cp_wait<G::NS - 1>();
      __syncthreads();
      body(it);
      __syncthreads();     // the stage is free again
    }
  }
  cp_wait<0>();
}

// the last key row `last_row` can see (+1), capped at Sk: keys at or past
// it are masked for every row up to last_row
__device__ __forceinline__ int key_end(const FlashArgs& a, const Head& hd,
                                       int last_row) {
  if (!a.causal) return a.Sk;
  const long long e = (long long)last_row + hd.off + 1;
  return e < 0 ? 0 : (e < a.Sk ? (int)e : a.Sk);
}

template <typename T>
__device__ __forceinline__ const T* plane(const void* p, long long bs,
                                          const Head& hd, int D) {
  return static_cast<const T*>(p) + hd.b * bs + (long long)hd.h * D;
}

// Shared memory: `nres` resident tiles of BM rows, then the staging ring
// (NS stages of two BN-row operands), then the f32 parts (operand 0 hi,
// lo, operand 1 hi, lo), then (dK/dV) NL slots of lse and delta.
template <typename T, int DP> struct Smem {
  using G = Tiles<T, DP>;
  static constexpr int BN = G::BN;
  T* res;
  T* ring;
  uint32_t* parts;
  __device__ Smem(unsigned char* base, int nres) {
    res = reinterpret_cast<T*>(base);
    ring = res + nres * BM * G::LDR;
    parts = reinterpret_cast<uint32_t*>(ring + G::NS * 2 * BN * G::LDS);
  }
  // stage of tile it, operand w (0 or 1)
  __device__ T* staged(int it, int w) const {
    return ring + ((it % G::NS) * 2 + w) * BN * G::LDS;
  }
  // operand w of tile it as the products read it
  __device__ Tile<T> view(int it, int w) const {
    Tile<T> v;
    if constexpr (G::F32) {
      v.hi = parts + 2 * w * BN * G::LD;
      v.lo = v.hi + BN * G::LD;
    } else {
      v.p = staged(it, w);
    }
    return v;
  }
  // the f32 split pass of tile it's two operands
  __device__ void split_both(int it, int D) const {
    if constexpr (G::F32) {
      const int n4 = ((D + 7) & ~7) / 4;
#pragma unroll
      for (int w = 0; w < 2; ++w)
        split_rows<BN, G::LDS, G::LD>(
            staged(it, w), parts + 2 * w * BN * G::LD,
            parts + (2 * w + 1) * BN * G::LD, n4);
    }
  }
  // dK/dV: NL slots of a tile's lse and delta (BN each)
  __device__ float* lse_delta() const {
    return reinterpret_cast<float*>(parts + (G::F32 ? 4 * BN * G::LD : 0));
  }
};

// ---- forward: a block per (BM·MT-row q tile, batch·head) --------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Tiles<T, DP>::FWD_MINB)
    flash_fwd_generic(const FlashArgs a, const int D, const Vecs vec) {
  using G = Tiles<T, DP>;
  extern __shared__ __align__(16) unsigned char gsm[];
  constexpr int LD = G::LD, LDR = G::LDR, LDS = G::LDS, BN = G::BN;
  constexpr int MT = G::MT, BQ = BM * MT, NT = BN / 8, ND = DP / 8;
  const Smem<T, DP> sm(gsm, MT);
  T* sQ = sm.res;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const Head hd = head_of(a, bh);
  const T* q = plane<T>(a.q, a.q_bs, hd, D);
  const T* k = plane<T>(a.k, a.k_bs, hd, D);
  const T* v = plane<T>(a.v, a.v_bs, hd, D);
  const int nt = (key_end(a, hd, min(q0 + BQ, a.Sq) - 1) + BN - 1) / BN;
  const int nk = (D + G::KS - 1) / G::KS, nd = (D + 7) / 8;

  zero_pad<T, LDR, G::KS>(sQ, BQ, D);
  zero_pad<T, LDS, G::KS>(sm.ring, G::NS * 2 * BN, D);
  load_rows<T, BQ, LDR>(sQ, q, a.q_rs, q0, a.Sq, D, vec.q);
  cp_commit();

  // this warp's m tiles start at row w0; a thread's rows are
  // w0 + 16mt + g + 8hh
  const int w0 = q0 + warp * 16 * MT;
  float o[MT][ND][4], m[MT][2], l[MT][2];
  unsigned rh[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = -INFINITY;
      l[mt][hh] = 0.f;
      rh[mt][hh] = a.seed ? row_hash(a, hd, w0 + 16 * mt + g + 8 * hh) : 0u;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][j][i] = 0.f;
  }

  stream<G>(
      nt,
      [&](int it) {
        load_rows<T, BN, LDS>(sm.staged(it, 0), k, a.k_rs, it * BN, a.Sk, D,
                              vec.k);
        load_rows<T, BN, LDS>(sm.staged(it, 1), v, a.v_rs, it * BN, a.Sk, D,
                              vec.v);
        cp_commit();
      },
      [&](int it) { sm.split_both(it, D); },
      [&](int it) {
        float s[MT][NT][4];
        mm_nt<T, MT, NT, LDR, LD>(s, sQ, sm.view(it, 0), w0 - q0, nk);
        const int k0 = it * BN;
        // no bias, no causal mask and every key inside Sk: only the scale
        // (rows past Sq are never stored)
        const bool plain = !a.causal && !hd.bias && k0 + BN <= a.Sk;
        float bc[NT][2];
        unsigned ch[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + 8 * j + 2 * t + e;
            bc[j][e] = col_bias(a, hd, c);
            ch[j][e] = a.seed ? col_hash(a, hd, c) : 0u;
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = w0 + 16 * mt + g + 8 * hh;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = s[mt][j][2 * hh + e];
                x = plain ? x * a.scale
                          : score<true>(a, hd, x, r, k0 + 8 * j + 2 * t + e,
                                        bc[j][e]);
                mx = fmaxf(mx, x);
              }
            const float mn = fmaxf(m[mt][hh], quad_max(mx));
            const float base = (mn == -INFINITY ? 0.f : mn) * LOG2E;
            // a max that holds keeps the scale: exp_diff(m, m·log2 e) is
            // off 1 by the rounding of m·log2 e, 2^±64 at m = -1e9
            const float alpha =
                m[mt][hh] == mn ? 1.f : exp_diff(m[mt][hh], base);
            float rs = 0.f;                 // l sums the undropped p
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = s[mt][j][2 * hh + e];
                const float pr = exp_diff(x, base);
                rs += pr;
                x = !a.seed ? pr
                            : (keep(a, rh[mt][hh] + ch[j][e])
                                   ? pr * a.drop_scale : 0.f);
              }
            l[mt][hh] = l[mt][hh] * alpha + rs;
            m[mt][hh] = mn;
            if (__any_sync(0xffffffffu, alpha != 1.f)) {  // a max moved
#pragma unroll
              for (int j = 0; j < ND; ++j) {
                o[mt][j][2 * hh] *= alpha;
                o[mt][j][2 * hh + 1] *= alpha;
              }
            }
          }
        mm_pv<T, MT, NT, ND, LD>(o, s, sm.view(it, 1), nd);
      });

  // a row that saw no key (l = 0) gives o = 0 and lse = NEG_INF
  T* out = static_cast<T*>(a.o) + hd.b * a.o_bs + (long long)hd.h * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lt = quad_sum(l[mt][hh]);
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      const int r = w0 + 16 * mt + g + 8 * hh;
      if (r >= a.Sq) continue;
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * j + 2 * t + e;
          if (d < D)
            out[r * a.o_rs + d] = from_f<T>(o[mt][j][2 * hh + e] * inv);
        }
      if (t == 0)
        a.lse[(long long)bh * a.Sq + r] =
            lt > 0.f ? m[mt][hh] + logf(lt) : NEG_INF;
    }
}

// ---- dQ: a block per (BM·MT-row q tile, batch·head), looping over k tiles

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Tiles<T, DP>::DQ_MINB)
    flash_bwd_dq_generic(const FlashArgs a, const int D, const Vecs vec) {
  using G = Tiles<T, DP>;
  extern __shared__ __align__(16) unsigned char gsm[];
  constexpr int LD = G::LD, LDR = G::LDR, LDS = G::LDS, BN = G::BN;
  constexpr int MT = G::MT, BQ = BM * MT, NT = BN / 8, ND = DP / 8;
  const Smem<T, DP> sm(gsm, 2 * MT);
  T* sQ = sm.res;
  T* sDO = sQ + BQ * LDR;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const Head hd = head_of(a, bh);
  const T* q = plane<T>(a.q, a.q_bs, hd, D);
  const T* k = plane<T>(a.k, a.k_bs, hd, D);
  const T* v = plane<T>(a.v, a.v_bs, hd, D);
  const T* dout = plane<T>(a.dout, a.do_bs, hd, D);
  const int nt = (key_end(a, hd, min(q0 + BQ, a.Sq) - 1) + BN - 1) / BN;
  const int nk = (D + G::KS - 1) / G::KS, nd = (D + 7) / 8;

  zero_pad<T, LDR, G::KS>(sQ, 2 * BQ, D);
  zero_pad<T, LDS, G::KS>(sm.ring, G::NS * 2 * BN, D);
  load_rows<T, BQ, LDR>(sQ, q, a.q_rs, q0, a.Sq, D, vec.q);
  load_rows<T, BQ, LDR>(sDO, dout, a.do_rs, q0, a.Sq, D, vec.dout);
  cp_commit();

  // this warp's m tiles start at row w0; a thread's rows are
  // w0 + 16mt + g + 8hh
  const int w0 = q0 + warp * 16 * MT;
  float acc[MT][ND][4], lse2[MT][2], delta[MT][2];
  unsigned rh[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = w0 + 16 * mt + g + 8 * hh;
      const bool in = r < a.Sq;
      lse2[mt][hh] = in ? a.lse[(long long)bh * a.Sq + r] * LOG2E : 0.f;
      delta[mt][hh] = in ? a.delta[(long long)bh * a.Sq + r] : 0.f;
      rh[mt][hh] = a.seed ? row_hash(a, hd, r) : 0u;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
  }

  stream<G>(
      nt,
      [&](int it) {
        load_rows<T, BN, LDS>(sm.staged(it, 0), k, a.k_rs, it * BN, a.Sk, D,
                              vec.k);
        load_rows<T, BN, LDS>(sm.staged(it, 1), v, a.v_rs, it * BN, a.Sk, D,
                              vec.v);
        cp_commit();
      },
      [&](int it) { sm.split_both(it, D); },
      [&](int it) {
        const Tile<T> cK = sm.view(it, 0);
        float s[MT][NT][4], dp[MT][NT][4];
        mm_nt<T, MT, NT, LDR, LD>(s, sQ, cK, w0 - q0, nk);
        mm_nt<T, MT, NT, LDR, LD>(dp, sDO, sm.view(it, 1), w0 - q0, nk);
        const int k0 = it * BN;
        const bool plain = !a.causal && !hd.bias && k0 + BN <= a.Sk;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + 8 * j + 2 * t + e;
            const float bc = col_bias(a, hd, c);
            const unsigned ch = a.seed ? col_hash(a, hd, c) : 0u;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int i = 2 * hh + e;
                const float x =
                    plain ? s[mt][j][i] * a.scale
                          : score<true>(a, hd, s[mt][j][i],
                                        w0 + 16 * mt + g + 8 * hh, c, bc);
                const float p = exp_diff(x, lse2[mt][hh]);
                float d = dp[mt][j][i];
                if (a.seed)
                  d = keep(a, rh[mt][hh] + ch) ? d * a.drop_scale : 0.f;
                dp[mt][j][i] = p * (d - delta[mt][hh]);   // dS
              }
          }
        mm_pv<T, MT, NT, ND, LD>(acc, dp, cK, nd);
      });

  store_rows<T, MT, ND>(static_cast<T*>(a.dq) + hd.b * a.dq_bs
                            + (long long)hd.h * D,
                        a.dq_rs, acc, a.scale, w0, a.Sq, D);
}

// ---- dK, dV: a block per (64-key tile, batch·head[, dV | dK]), looping
// over q tiles ----------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Tiles<T, DP>::DKV_MINB)
    flash_bwd_dkv_generic(const FlashArgs a, const int D, const Vecs vec) {
  using G = Tiles<T, DP>;
  extern __shared__ __align__(16) unsigned char gsm[];
  constexpr int LD = G::LD, LDR = G::LDR, LDS = G::LDS, BN = G::BN;
  constexpr int MT = 1, BK = BM, NT = BN / 8, ND = DP / 8;
  constexpr bool SPLIT = G::SPLIT;
  const Smem<T, DP> sm(gsm, 2 * MT);
  T* sK = sm.res;
  T* sV = sK + BK * LDR;
  float* sLD = sm.lse_delta();   // slot s: lse at 2s·BN, delta BN after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  // 0: dV only, 1: dK only (the two slices at DP >= 128), 2: both
  const int mode = SPLIT ? (int)blockIdx.z : 2;
  const Head hd = head_of(a, bh);
  const T* q = plane<T>(a.q, a.q_bs, hd, D);
  const T* k = plane<T>(a.k, a.k_bs, hd, D);
  const T* v = plane<T>(a.v, a.v_bs, hd, D);
  const T* dout = plane<T>(a.dout, a.do_bs, hd, D);
  const float* lse = a.lse + (long long)bh * a.Sq;
  const float* dl = a.delta + (long long)bh * a.Sq;
  const int nk = (D + G::KS - 1) / G::KS, nd = (D + 7) / 8;

  // rows before the causal frontier of the tile's first key see none of it
  int qstart = 0;
  if (a.causal) {
    const long long first = (long long)k0 - hd.off;
    qstart = first <= 0 ? 0 : (first < a.Sq ? (int)first : a.Sq);
    qstart -= qstart % BN;
  }
  const int nt = (a.Sq - qstart + BN - 1) / BN;

  zero_pad<T, LDR, G::KS>(sK, 2 * BK, D);
  zero_pad<T, LDS, G::KS>(sm.ring, G::NS * 2 * BN, D);
  load_rows<T, BK, LDR>(sK, k, a.k_rs, k0, a.Sk, D, vec.k);
  load_rows<T, BK, LDR>(sV, v, a.v_rs, k0, a.Sk, D, vec.v);
  cp_commit();

  // this warp's m tiles start at key w0; a thread's keys are
  // w0 + 16mt + g + 8hh
  const int w0 = k0 + warp * 16 * MT;
  // no bias, no causal mask and every key inside Sk: only the scale (q
  // rows past Sq are zeros, as are their dO rows, so they add nothing)
  const bool plain = !a.causal && !hd.bias && k0 + BK <= a.Sk;
  float bc[MT][2];
  unsigned ch[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = w0 + 16 * mt + g + 8 * hh;
      bc[mt][hh] = col_bias(a, hd, c);
      ch[mt][hh] = a.seed ? col_hash(a, hd, c) : 0u;
    }
  // dV (or the slice's one output) and dK
  float acc0[MT][ND][4], acc1[MT][SPLIT ? 1 : ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc0[mt][j][i] = 0.f;
#pragma unroll
    for (int j = 0; j < (SPLIT ? 1 : ND); ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[mt][j][i] = 0.f;
  }

  stream<G>(
      nt,
      [&](int it) {
        const int r0 = qstart + it * BN;
        load_rows<T, BN, LDS>(sm.staged(it, 0), q, a.q_rs, r0, a.Sq, D,
                              vec.q);
        load_rows<T, BN, LDS>(sm.staged(it, 1), dout, a.do_rs, r0, a.Sq, D,
                              vec.dout);
        float* sl = sLD + (it % G::NL) * 2 * BN;
        for (int i = threadIdx.x; i < 2 * BN; i += kThreads) {
          const int r = r0 + i % BN;
          const bool in = r < a.Sq;
          cp_async<4>(sl + i, (i < BN ? lse : dl) + (in ? r : 0), in);
        }
        cp_commit();
      },
      [&](int it) { sm.split_both(it, D); },
      [&](int it) {
        const Tile<T> cQ = sm.view(it, 0), cDO = sm.view(it, 1);
        const float* cL = sLD + (it % G::NL) * 2 * BN;
        const int q0 = qstart + it * BN;
        // transposed tiles: rows are this warp's keys, columns the q rows
        float s[MT][NT][4], dp[MT][NT][4];
        mm_nt<T, MT, NT, LDR, LD>(s, sK, cQ, w0 - k0, nk);
        if (mode != 0) mm_nt<T, MT, NT, LDR, LD>(dp, sV, cDO, w0 - k0, nk);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * t + e, r = q0 + cl;
            const float lse2 = cL[cl] * LOG2E, delta = cL[BN + cl];
            const unsigned rh = a.seed ? row_hash(a, hd, r) : 0u;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int i = 2 * hh + e;
                const float x =
                    plain ? s[mt][j][i] * a.scale
                          : score<true>(a, hd, s[mt][j][i], r,
                                        w0 + 16 * mt + g + 8 * hh,
                                        bc[mt][hh]);
                const float p = exp_diff(x, lse2);
                // the kept share's factor: 1/(1 − rate) or 0 (1 without
                // dropout)
                const float f =
                    !a.seed ? 1.f
                            : (keep(a, rh + ch[mt][hh]) ? a.drop_scale : 0.f);
                s[mt][j][i] = p * f;                     // P̃
                if (mode != 0)
                  dp[mt][j][i] = p * (dp[mt][j][i] * f - delta);   // dS
              }
          }
        if constexpr (SPLIT) {
          if (mode == 0) mm_pv<T, MT, NT, ND, LD>(acc0, s, cDO, nd);
          else mm_pv<T, MT, NT, ND, LD>(acc0, dp, cQ, nd);
        } else {
          mm_pv<T, MT, NT, ND, LD>(acc0, s, cDO, nd);
          mm_pv<T, MT, NT, ND, LD>(acc1, dp, cQ, nd);
        }
      });

  T* gdk = static_cast<T*>(a.dk) + hd.b * a.dkv_bs + (long long)hd.h * D;
  T* gdv = static_cast<T*>(a.dv) + hd.b * a.dkv_bs + (long long)hd.h * D;
  if constexpr (SPLIT) {
    if (mode == 0)
      store_rows<T, MT, ND>(gdv, a.dkv_rs, acc0, 1.f, w0, a.Sk, D);
    else
      store_rows<T, MT, ND>(gdk, a.dkv_rs, acc0, a.scale, w0, a.Sk, D);
  } else {
    store_rows<T, MT, ND>(gdv, a.dkv_rs, acc0, 1.f, w0, a.Sk, D);
    store_rows<T, MT, ND>(gdk, a.dkv_rs, acc1, a.scale, w0, a.Sk, D);
  }
}

// ---- launches -----------------------------------------------------------------

// the largest copy (bytes) that divides the base, the strides and a row
template <typename T>
int vec_of(const void* p, long long bs, long long rs, int d) {
  constexpr int e = sizeof(T);
  for (int w = 16; w > e; w /= 2)
    if ((uintptr_t)p % w == 0 && (bs * e) % w == 0 && (rs * e) % w == 0
        && (d * e) % w == 0)
      return w;
  return e;
}

template <typename T, int DP>
int fwd(const FlashArgs& a, int d, cudaStream_t st) {
  using G = Tiles<T, DP>;
  const Vecs vec{vec_of<T>(a.q, a.q_bs, a.q_rs, d),
                 vec_of<T>(a.k, a.k_bs, a.k_rs, d),
                 vec_of<T>(a.v, a.v_bs, a.v_rs, d), 16};
  int err = smem_optin((const void*)flash_fwd_generic<T, DP>, G::fwd_bytes);
  if (err) return err;
  const dim3 grid((a.Sq + BM * G::MT - 1) / (BM * G::MT), a.B * a.H);
  flash_fwd_generic<T, DP><<<grid, kThreads, G::fwd_bytes, st>>>(a, d, vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd(const FlashArgs& a, int d, cudaStream_t st) {
  using G = Tiles<T, DP>;
  const Vecs vec{vec_of<T>(a.q, a.q_bs, a.q_rs, d),
                 vec_of<T>(a.k, a.k_bs, a.k_rs, d),
                 vec_of<T>(a.v, a.v_bs, a.v_rs, d),
                 vec_of<T>(a.dout, a.do_bs, a.do_rs, d)};
  int err = smem_optin((const void*)flash_bwd_dkv_generic<T, DP>,
                       G::dkv_bytes);
  if (!err)
    err = smem_optin((const void*)flash_bwd_dq_generic<T, DP>, G::dq_bytes);
  if (err) return err;
  constexpr int BQ = BM * G::MT;   // q rows of a dQ block
  const dim3 kv_grid((a.Sk + BM - 1) / BM, a.B * a.H, G::SPLIT ? 2 : 1);
  flash_bwd_dkv_generic<T, DP><<<kv_grid, kThreads, G::dkv_bytes, st>>>(
      a, d, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 q_grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_generic<T, DP><<<q_grid, kThreads, G::dq_bytes, st>>>(a, d,
                                                                      vec);
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
