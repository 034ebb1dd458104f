// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu) for Hopper (sm_90a): the argument block, the tensor
// maps and TMA loads, mbarriers, wgmma and its shared-memory descriptors,
// the accumulator fragment's coordinates, the 16-byte output stores, and
// the score element's masks, bias and softmax-dropout hash.
//
// Layout: q, o, do and dq are (B, Sq, H, D) tensors, k, v, dk and dv are
// (B, Sk, H, D), each head row D contiguous elements; the kernels take each
// tensor's batch and row strides (elements), so q/k/v may be views of one
// packed (B, S, 3·H·D) projection. lse and delta are f32 (B·H, Sq). The
// optional f32 bias is read at (b, h, row, key) through four element
// strides, 0 on a broadcast dim, so a (B, 1, 1, Sk) padding mask is never
// expanded in memory.
//
// Design shared by the three kernels. A persistent block (one an SM)
// takes work items in turn; it has two consumer warpgroups (warps 0-7),
// each owning 64 rows of the item's 128-row resident tile, and one
// producer warp (warp 8). The producer's lane 0 issues TMA loads of whole
// tiles through 4-D tensor maps (D, H, S, B) built from FlashArgs' strides
// on every call; TMA zero-fills rows past S, which the bounds tests still
// mask. Resident tiles alternate between two buffers, each with a full
// and an empty mbarrier. Streamed tiles pass through a ring of NS stages,
// each with a full and an empty mbarrier: the producer's 32 lanes arrive
// on `full` (lane 0 with the transaction bytes) after staging the tile's
// per-row or per-key terms (bias, dropout hash, lse, delta) in shared
// memory, and every consumer warp arrives on `empty` once its products
// are done. All
// products are wgmma.mma_async m64nNk16 with f32 accumulators in
// registers: A and B K-major in swizzled shared memory, or A from
// registers (probabilities or dS, converted from the previous product's
// accumulators in place) and B MN-major through the transpose bit. A tile
// of 16-bit rows is loaded in boxes of 32 rows by min(D, 64) columns, so
// every box row is the swizzle span (128 bytes; 64 bytes at D = 32) and
// D = 128 is two boxes side by side. The two consumer warpgroups take
// ping-pong turns to issue their products.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace apex_flash {

constexpr int NCONS = 2;                  // consumer warpgroups a block
constexpr int BM = 64 * NCONS;            // tile rows a block owns
constexpr int NTHREADS = NCONS * 128 + 32;  // + the producer warp
constexpr int PRODUCER_WARP = NCONS * 4;
constexpr int NS = 3;                     // stages of a streamed ring
// lse of a row that sees no key, as the JAX package's kernels give it
constexpr float NEG_INF = -1e30f;

// Everything a launch needs, for both directions. Mirrored field for field
// by apex_tpu_torch/ops/attention.py::_FlashArgs. A null bias, seed, dbo
// or causal_off pointer turns that option off (causal_off null: the
// frontier is off_static).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  const float* delta;
  const float* bias;
  const int* seed;          // dropout seed (int32, read on the device)
  const int* dbo;           // dropout (q-block, k-block) offsets
  const int* causal_off;    // causal frontier (int32, read on the device)
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;
  long long dq_bs, dq_rs, dkv_bs, dkv_rs;
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  int B, H, Sq, Sk;
  int causal, off_static;
  int drop_bq, drop_bk;     // the JAX kernels' dropout blocks
  unsigned keep_threshold;  // keep iff hash >= this: uint32(rate·2^32)
  float drop_scale;         // 1/(1 - rate) in f32
  float scale;
};

// Shared-memory geometry of a tile of 16-bit rows of D elements.
template <int D> struct Geo {
  static constexpr int BOXD = D < 64 ? D : 64;  // columns of a TMA box
  static constexpr int NBOX = D / BOXD;         // boxes side by side
  static constexpr int SW = BOXD * 2;           // bytes of a box row
  static constexpr uint32_t MODE = SW == 128 ? 1u : 2u;  // wgmma swizzle
};

// two f32 as one 32-bit register of two 16-bit values, lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                                float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(
    float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                              float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// orders this thread's shared-memory accesses before later TMA writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Wait until the barrier has completed the phase of parity `parity`. A
// wait past 10 s of the global timer traps, so a pipeline fault ends the
// launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (unsigned n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

constexpr int BOX_ROWS = 32;   // rows of a TMA box; tiles are multiples

// Rows [r0, r0 + R) of head (b, h) into a tile at `dst` (1024-byte
// aligned): box (column block cb, row block rb) at cb·R·SW + rb·32·SW,
// which is one swizzled [R][D] tile per column block.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int R, int r0, int h,
                                         int b) {
  using G = Geo<D>;
  for (int cb = 0; cb < G::NBOX; ++cb)
    for (int rb = 0; rb < R / BOX_ROWS; ++rb)
      tma_load4(dst + cb * R * G::SW + rb * BOX_ROWS * G::SW, map, bar,
                cb * G::BOXD, h, r0 + rb * BOX_ROWS, b);
}

// --- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// all but the most recently committed group complete
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products' issue and wait.
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle mode (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)mode << 62);
}
// K-major operand: rows [r0, r0 + 64 or N) of an R-row tile at `base`, the
// 16 columns of k-step kk. A 16-column step stays inside one box row; the
// swizzle atom is 8 rows (SBO).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int R, int r0,
                                           int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  return smem_desc(base + (col / G::BOXD) * R * G::SW + r0 * G::SW
                       + (col % G::BOXD) * 2,
                   16, 8 * G::SW, G::MODE);
}
// MN-major B operand [K = tile rows][N = D]: rows 16kk.. of an R-row tile;
// the next box along N is R·SW bytes on (LBO), the next 8 rows along K one
// atom on (SBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int R, int kk) {
  using G = Geo<D>;
  return smem_desc(base + kk * 16 * G::SW, R * G::SW, 8 * G::SW, G::MODE);
}

// wgmma.mma_async m64nNk16, f32 += 16-bit: ss() with A and B K-major in
// shared memory, rs() with A from registers and B MN-major (transposed).
// acc = 0 overwrites d.
template <typename T, int N> struct Wgmma;

#define APEX_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define APEX_D16(i) APEX_D4(i), APEX_D4(i + 4), APEX_D4(i + 8), APEX_D4(i + 12)
#define APEX_D32 APEX_D16(0), APEX_D16(16)
#define APEX_D64 APEX_D32, APEX_D16(32), APEX_D16(48)
#define APEX_R16                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define APEX_R32                                                          \
  APEX_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "    \
           "%27, %28, %29, %30, %31"
#define APEX_R64                                                          \
  APEX_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
           "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
           "%55, %56, %57, %58, %59, %60, %61, %62, %63"
// N, PTX type, accumulator operand list (in parentheses) and its string,
// then the operand numbers after the accumulators: SS (a, b, acc) and RS
// (a, b, acc)
#define APEX_UNPAREN(...) __VA_ARGS__
#define APEX_WGMMA(N, CT, TY, DOUT, DSTR, SA, SB, SP, RA, RB, RP)          \
  template <> struct Wgmma<CT, N> {                                         \
    static __device__ __forceinline__ void ss(float (&d)[N / 2],            \
                                              uint64_t da, uint64_t db,     \
                                              int acc) {                    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SP ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY     \
                   "." TY " {" DSTR "}, " SA ", " SB ", p, 1, 1, 0, 0;\n}"  \
                   : APEX_UNPAREN DOUT : "l"(da), "l"(db), "r"(acc));      \
    }                                                                       \
    static __device__ __forceinline__ void rs(float (&d)[N / 2],            \
                                              const uint32_t (&a)[4],       \
                                              uint64_t db, int acc) {       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RP ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY     \
                   "." TY " {" DSTR "}, " RA ", " RB ", p, 1, 1, 1;\n}"     \
                   : APEX_UNPAREN DOUT : "r"(a[0]), "r"(a[1]), "r"(a[2]),  \
                     "r"(a[3]), "l"(db), "r"(acc));                         \
    }                                                                       \
  };
#define APEX_WGMMA_BOTH(N, DOUT, DSTR, SA, SB, SP, RA, RB, RP)              \
  APEX_WGMMA(N, __nv_bfloat16, "bf16", DOUT, DSTR, SA, SB, SP, RA, RB, RP)  \
  APEX_WGMMA(N, __half, "f16", DOUT, DSTR, SA, SB, SP, RA, RB, RP)
APEX_WGMMA_BOTH(32, (APEX_D16(0)), APEX_R16, "%16", "%17", "%18",
                "{%16, %17, %18, %19}", "%20", "%21")
APEX_WGMMA_BOTH(64, (APEX_D32), APEX_R32, "%32", "%33", "%34",
                "{%32, %33, %34, %35}", "%36", "%37")
APEX_WGMMA_BOTH(128, (APEX_D64), APEX_R64, "%64", "%65", "%66",
                "{%64, %65, %66, %67}", "%68", "%69")
#undef APEX_WGMMA_BOTH
#undef APEX_WGMMA
#undef APEX_R64
#undef APEX_R32
#undef APEX_R16
#undef APEX_D64
#undef APEX_D32
#undef APEX_D16
#undef APEX_D4
#undef APEX_UNPAREN

// The m64nN accumulator fragment: thread t of a warpgroup holds, for each
// 8-column chunk j, d[4j + 2h + e] at row 16·warp + lane/4 + 8h and column
// 8j + 2·(lane%4) + e. Four lanes share a row. The A operand of an RS
// product over columns [16kk, 16kk + 16) is d[8kk .. 8kk + 8) in pairs.
template <typename T, int NR>
__device__ __forceinline__ void frag_to_a(uint32_t (&a)[NR / 8][4],
                                          const float (&d)[NR]) {
#pragma unroll
  for (int kk = 0; kk < NR / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<T>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// e^(x - y) as 2^(x·log2 e − y·log2 e): one FFMA and the SFU's
// ex2.approx (results below 2^-126 flush to 0), within a few ulps of
// expf. x = -inf gives 0. `yl` is y·log2 e.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp_diff(float x, float yl) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaf(x, LOG2E, -yl)));
  return r;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// barrier of one consumer warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}
// Ping-pong between the two consumer warpgroups: a warpgroup issues its
// products only in its turn (named barrier 3 + wg, completed by the other
// warpgroup's pass), so one warpgroup's elementwise work runs while the
// other's products hold the tensor cores. Warpgroup 1 passes once first,
// so warpgroup 0 takes the first turn, and warpgroup 0 waits once last, so
// every pass is taken; between those both take the same number of turns.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(3 + (wg ^ 1)) : "memory");
}

// --- 16-byte output stores --------------------------------------------------

// A warpgroup's 64 rows x D accumulator, in T, into a staging region laid
// out as the TMA tiles are (box cb at base + cb·box_stride, rows of SW
// bytes) with 16-byte chunks XOR-swizzled by the row against bank
// conflicts.
template <typename T, int D>
__device__ __forceinline__ void frag_to_stage(unsigned char* base,
                                              int box_stride,
                                              const float (&acc)[D / 2]) {
  using G = Geo<D>;
  constexpr int CHB = G::BOXD / 8;     // 16-byte chunks in a box row
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * w + lane / 4 + 8 * hh;
      const int cb = j / CHB, ch = (j % CHB) ^ (row & (CHB - 1));
      *reinterpret_cast<uint32_t*>(base + cb * box_stride + row * G::SW
                                   + ch * 16 + (lane % 4) * 4) =
          pack2<T>(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
}
// The staged 64 rows to rows [r0, r0 + 64) of one head (row stride rs),
// 16 bytes a thread, rows at or past S skipped.
template <int D>
__device__ __forceinline__ void stage_to_global(const unsigned char* base,
                                                int box_stride, void* dst,
                                                long long rs, int r0, int S) {
  using G = Geo<D>;
  constexpr int CHB = G::BOXD / 8, CH = D / 8;
  const int tid = threadIdx.x % 128;
  for (int i = tid; i < 64 * CH; i += 128) {
    const int row = i / CH, c = i % CH;
    if (r0 + row >= S) break;
    const int cb = c / CHB, ch = (c % CHB) ^ (row & (CHB - 1));
    const uint4 v = *reinterpret_cast<const uint4*>(
        base + cb * box_stride + row * G::SW + ch * 16);
    *reinterpret_cast<uint4*>(static_cast<unsigned char*>(dst)
                              + ((long long)(r0 + row) * rs + c * 8) * 2) = v;
  }
}

// --- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// error codes of the entry points beyond cudaError_t's
constexpr int ERR_NO_ENCODER = 10001;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10002;       // the driver refused a tensor map

// The 4-D map (D, H, S, B) of a (B, S, H, D) tensor with batch stride bs
// and row stride rs (elements), boxes of BOX_ROWS rows x min(D, 64)
// columns, swizzled as Geo<D> says. Returns 0 or an error code.
template <typename T, int D>
int encode_map(CUtensorMap* m, const void* base, long long bs, long long rs,
               int H, int S, int B) {
  using G = Geo<D>;
  EncodeTiled enc = encode_tiled();
  if (!enc) return ERR_NO_ENCODER;
  // a size-1 dim's stride is never used: keep it one the driver takes
  if (S == 1) rs = (long long)H * D;
  if (B == 1) bs = rs * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)rs * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::BOXD, 1, BOX_ROWS, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      m,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// The card's SM count: the persistent kernels launch a block an SM.
inline int sm_count(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  return err;
}

inline int smem_optin(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Registers. ptxas budgets a 288-thread block at 168 registers a thread
// (it counts whole warpgroups: 65536 / 384), so one block fits an SM.
// setmaxnreg, to move the producer's registers to the consumers, did not
// raise that budget for the consumers' code (their spills stayed) and it
// is warpgroup-wide, which a lone producer warp is not: it is not used.

// --- one (batch, head) and its score elements -------------------------------

struct Head {
  int b, h;
  const float* bias;   // this head's bias plane, or null
  int off;             // causal frontier: row r sees key c iff r + off >= c
  unsigned hash_base;  // seed + (b·H + h)·0x9E3779B9, dropout only
  int dbo_q, dbo_k;
};

__device__ __forceinline__ Head head_of(const FlashArgs& a, int bh) {
  Head hd;
  hd.b = bh / a.H;
  hd.h = bh % a.H;
  hd.bias = a.bias ? a.bias + hd.b * a.bias_sb + hd.h * a.bias_sh : nullptr;
  hd.off = a.causal_off ? *a.causal_off : a.off_static;
  hd.hash_base = a.seed ? (unsigned)*a.seed + (unsigned)bh * 0x9E3779B9u : 0u;
  hd.dbo_q = a.dbo ? a.dbo[0] : 0;
  hd.dbo_k = a.dbo ? a.dbo[1] : 0;
  return hd;
}

// The kernels are compiled twice: OPTS = false for a call with no bias, no
// causal mask and no dropout (BERT without padding), whose per-element work
// stays a scale and a bounds test, and OPTS = true for everything else.

// The bias at key c when it does not vary along rows (bias_sq = 0, as a
// (B, 1, 1, Sk) padding mask), so it is staged once a tile; 0 otherwise.
__device__ __forceinline__ float col_bias(const FlashArgs& a, const Head& hd,
                                          int c) {
  return hd.bias && a.bias_sq == 0 && c < a.Sk ? hd.bias[c * a.bias_sk] : 0.f;
}

// s = raw·scale + bias at global (r, c), or -inf where the element is
// masked: a row past Sq, a key past Sk, or a key past the causal frontier.
// `bc` is col_bias(c).
template <bool OPTS>
__device__ __forceinline__ float score(const FlashArgs& a, const Head& hd,
                                       float raw, int r, int c, float bc) {
  if (r >= a.Sq || c >= a.Sk) return -INFINITY;
  if constexpr (!OPTS) {
    return raw * a.scale;
  } else {
    if (a.causal && r + hd.off < c) return -INFINITY;
    float s = raw * a.scale;
    if (hd.bias) s += a.bias_sq ? hd.bias[r * a.bias_sq + c * a.bias_sk] : bc;
    return s;
  }
}

// The softmax-dropout mask of the JAX package (attention.py::_mix_keep):
// a lowbias32 avalanche over (seed, b·H + h, q-block, k-block, row in
// block, column in block), the blocks being the JAX kernels' dropout
// blocks (drop_bq, drop_bk) shifted by the block offsets. uint32
// arithmetic wraps as it does there. The row and column terms are summed
// apart so a loop computes each once.
__device__ __forceinline__ unsigned row_hash(const FlashArgs& a,
                                             const Head& hd, int r) {
  const unsigned iq = (unsigned)(r / a.drop_bq + hd.dbo_q);
  return hd.hash_base + iq * 0x85EBCA6Bu
         + (unsigned)(r % a.drop_bq) * 0x27D4EB2Fu;
}
__device__ __forceinline__ unsigned col_hash(const FlashArgs& a,
                                             const Head& hd, int c) {
  const unsigned ik = (unsigned)(c / a.drop_bk + hd.dbo_k);
  return ik * 0xC2B2AE35u + (unsigned)(c % a.drop_bk) * 0x165667B1u;
}
__device__ __forceinline__ bool keep(const FlashArgs& a, unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= a.keep_threshold;
}

// --- the producer warp ------------------------------------------------------

// Addresses of a ring's barriers: full[s] at bars + 8s, empty[s] at
// bars + 8(NS + s).
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) {
  return bars + 8 * s;
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (NS + s);
}
// One barrier `one` for the resident tiles, then the ring's: the producer's
// 32 lanes fill a stage, every consumer warp empties it.
__device__ __forceinline__ void init_barriers(uint32_t one, uint32_t bars) {
  if (threadIdx.x == 0) {
    if (one) mbar_init(one, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full(bars, s), 32);
      mbar_init(bar_empty(bars, s), NCONS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Stream nt tiles of BN keys of k and v into the ring at `ring` (stage s:
// k at ring + 2s·BN·D·2, v BN·D·2 after it), with each tile's per-key bias
// (bias_sq = 0) and dropout hash terms in sBias/sHc[s·BN + key in tile].
// g0 tiles went through the ring before these. Run by the whole producer
// warp.
template <int D, bool OPTS, int BN>
__device__ __forceinline__ void produce_kv(const FlashArgs& a, const Head& hd,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           uint32_t ring, uint32_t bars,
                                           float* sBias, unsigned* sHc,
                                           int nt, int g0) {
  constexpr uint32_t TB = BN * D * 2;
  constexpr int PER = BN / 32;
  const int lane = threadIdx.x % 32;
  // a tile's bias is read a tile ahead, so its latency passes while the
  // producer waits for a free stage
  float nb[PER];
  auto fetch = [&](int t) {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      nb[j] = OPTS && t < nt ? col_bias(a, hd, t * BN + lane + 32 * j) : 0.f;
  };
  fetch(0);
  for (int t = 0; t < nt; ++t) {
    const int s = (g0 + t) % NS, k0 = t * BN;
    mbar_wait(bar_empty(bars, s), (((g0 + t) / NS) & 1) ^ 1);
    if (OPTS) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = lane + 32 * j;
        sBias[s * BN + i] = nb[j];
        if (a.seed) sHc[s * BN + i] = col_hash(a, hd, k0 + i);
      }
      fetch(t + 1);
    }
    if (lane == 0) {
      const uint32_t dst = ring + 2 * s * TB, full = bar_full(bars, s);
      mbar_arrive_tx(full, 2 * TB);
      tma_tile<D>(dst, tk, full, BN, k0, hd.h, hd.b);
      tma_tile<D>(dst + TB, tv, full, BN, k0, hd.h, hd.b);
    } else {
      mbar_arrive(bar_full(bars, s));
    }
  }
}

// The shared-memory base, rounded up to the 1024 bytes a 128-byte swizzle
// atom spans (launches ask for 1024 bytes more than they lay out).
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
}

}  // namespace apex_flash
