// LayerNorm backward for Hopper (sm_90a): from the upstream gradient g and
// the input x of (n, h) rows, dx = rstd·(gw - mean(gw) - x̂·mean(gw·x̂)) in
// x's dtype, with x̂ = (x - mean)·rstd and gw = g·γ (gw = g without affine
// params), and with affine params dγ = Σ_rows g·x̂ and dβ = Σ_rows g in f32.
//
// Replaces apex_tpu/ops/layer_norm.py::_ln_bwd_kernel (the pallas_call in
// _ln_backward). The moments are recomputed from x as the forward takes
// them (centred, two passes, in f32); nothing but x and γ is saved.
//
// What bounds it on an H100: bytes. One read of x and g and one write of
// dx (BERT-Large: (8192, 1024) bf16, 50.3 MB, 15.0 us at 3.35 TB/s)
// against ~20 flops an element. The Triton kernel it replaces kept one
// row in flight a 4-warp program, with four cross-warp reductions a row,
// and summed its (2, 528, h) dγ/dβ partials in a second launch.
//
// Design (layer_norm_common.cuh has the parts the forward shares).
// - ln_bwd_warp: a warp owns a row, the forward's layout: each lane holds
//   NC chunks of CH elements of x and of g raw in registers (16-byte
//   vectors where x's and g's bases and the row allow, else one element a
//   load), and dx goes out as 16-byte vectors. Four xor-shuffle sums a
//   row: Σx, Σ(x - mean)², then Σgw and Σgw·x̂ together. γ is read once a
//   block into shared memory as f32, laid out [element of the lane][lane].
//   On the vector path up to 32 elements a lane, the next row's x and g
//   are loaded before this row's sums, so two rows a warp are in flight.
// - dγ and dβ: each warp adds g·x̂ and g of its rows into a slab of shared
//   memory of its own, [element of the lane][lane] (no bank conflicts, no
//   barrier: a lane touches only its own words). In registers they would
//   double the forward's 64 registers at h = 1024 and cut the blocks an
//   SM. The block then adds its warps' slabs in warp order and writes one
//   f32 partial row (dγ then dβ) into a workspace.
// - The plan is a pure function of the shape (layer_norm._ln_bwd_plan):
//   at most 256 blocks, each owning a run of `rows` rows (its warps take
//   every 8th row of it), so the order of every sum is fixed and two
//   launches agree bit for bit on any card.
// - The partials are added in the same launch, with no float atomics:
//   behind a release fence each block draws an integer ticket; the last 32
//   blocks to draw wait until all have, then each adds a 32nd of the
//   columns over all the partials (finish() below). Summing them in one
//   block, as the BN sums do, leaves one SM to read all 256 partials (2 MB
//   at h = 1024) from L2 alone (`ln_bwd_one_finisher` in
//   scripts/torch_kernel_variants.py), and two levels of 16 blocks would
//   still leave two such reads on the critical path.
// - ln_bwd_block: a row wider than 2048 (or an f32 row of one element a
//   load past 512) takes a 256-thread block, x and g staged in shared
//   memory as T while 2·h·sizeof(T) <= 223232 bytes, else read again from
//   the caches each pass; its threads add their columns' dγ and dβ into the
//   block's partial row directly.
#include "layer_norm_common.cuh"

#include <climits>

namespace {

// bytes of x and g a block stages, leaving room for its static shared
// memory (finish()'s) within the 227 KB opt-in
constexpr int kMaxStagedBwd = kMaxStaged - 8192;
constexpr int kChunk = 16;      // partial rows a thread adds in one go
constexpr int kFinishers = 32;  // blocks that add the partials, at most
constexpr int kSlots = kThreads / kChunk;   // column groups a finisher pass

struct LnBwdArgs {
  const void* g;
  const void* x;
  const void* w;                // null: not affine (no dγ, dβ, partials)
  void* dx;
  float* part;                  // (blocks, ld) f32 partial rows
  int* counters;                // (2,), 0 between launches
  float* out;                   // (2, h): dγ, dβ
  long long n, rows;            // rows a block (the last takes the rest)
  int h, ld, w_dtype, blocks;
  float eps;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// After the block's partial row is written. After a barrier, one thread
// of each block draws an integer ticket behind a release fence (the
// block's partial writes, ordered before it by the barrier, are visible
// to whoever acquires the ticket's count); the last kFinishers blocks to
// draw (all blocks of a smaller grid) each wait with an acquire load
// until every block has drawn one, then add a share of the columns:
// thread (slot, chunk) adds kChunk partial rows of a float4 column group
// in block order, and the chunks' sums are added in chunk order through
// shared memory. The order of every sum is fixed by the shape; which
// block adds a column is not, and does not change the bits. The finishers
// are the last blocks running, so the ones they wait for are running too
// (or start as soon as one of the card's other slots frees up: only
// kFinishers blocks ever wait). The last finisher sets both counters back
// to 0. A wait past 10 s traps instead of holding the card.
__device__ __forceinline__ void finish(const LnBwdArgs& a) {
  __shared__ int ticket;
  __shared__ float4 red[kChunk][kSlots];
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    ticket = atomicAdd(&a.counters[0], 1);
  }
  __syncthreads();
  const int finishers = min(kFinishers, a.blocks);
  const int j = ticket - (a.blocks - finishers);
  if (j < 0) return;
  if (threadIdx.x == 0) {
    unsigned long long t0 = 0;
    for (int n = 1; load_acquire(a.counters) < a.blocks; ++n) {
      __nanosleep(32);
      if (n % 1024 == 0) {
        unsigned long long now;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
        if (t0 == 0) t0 = now;
        else if (now - t0 > 10000000000ull) __trap();
      }
    }
  }
  __syncthreads();
  const int groups4 = a.ld / 4;                  // float4 column groups
  const int per = (groups4 + finishers - 1) / finishers;
  const int g_end = min(groups4, (j + 1) * per);
  const int slot = threadIdx.x % kSlots, chunk = threadIdx.x / kSlots;
  const int r0 = chunk * kChunk;
  const int cols = 2 * a.h;
  for (int g0 = j * per; g0 < g_end; g0 += kSlots) {
    const int gi = g0 + slot;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi < g_end && r0 < a.blocks) {
      float4 p[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        p[k] = __ldcg(reinterpret_cast<const float4*>(
            a.part + (long long)min(r0 + k, a.blocks - 1) * a.ld + gi * 4));
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (r0 + k < a.blocks) {
          s.x += p[k].x;
          s.y += p[k].y;
          s.z += p[k].z;
          s.w += p[k].w;
        }
      }
    }
    red[chunk][slot] = s;
    __syncthreads();
    if (chunk == 0 && gi < g_end) {
      float4 v = red[0][slot];
      for (int c = 1; c * kChunk < a.blocks; ++c) {
        v.x += red[c][slot].x;
        v.y += red[c][slot].y;
        v.z += red[c][slot].z;
        v.w += red[c][slot].w;
      }
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (gi * 4 + q < cols) a.out[gi * 4 + q] = e[q];
    }
    __syncthreads();            // red is written again by the next pass
  }
  if (threadIdx.x == 0 && atomicAdd(&a.counters[1], 1) == finishers - 1) {
    a.counters[0] = 0;
    a.counters[1] = 0;
  }
}

// The blocks an SM that the launch bounds ask for: on the vector path, as
// many as 4·NC raw 16-byte chunks (x and g of this row and the next, 4
// registers each) and about 64 more registers allow (2 at h = 1024 bf16:
// 128 registers a thread); the scalar path asks for one and lets ptxas
// choose.
template <int CH, int NC>
struct Fit {
  static constexpr int kFit = 65536 / (kThreads * (NC * 16 + 64));
  static constexpr int kBlocks =
      CH == 1 || kFit < 1 ? 1 : kFit > 4 ? 4 : kFit;
};

template <typename T, int CH, int NC>
__global__ void __launch_bounds__(kThreads, Fit<CH, NC>::kBlocks)
ln_bwd_warp(const LnBwdArgs a) {
  using C = Chunk<T, CH>;
  constexpr int E = CH * NC;
  // the next row's loads go out before this row's sums on the vector path
  // up to 32 elements a lane (the registers of two rows)
  constexpr bool kAhead = CH > 1 && NC <= 4;
  // γ, then each warp's slab of Σg·x̂ and Σg: all [element of the lane][lane]
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* sw = smem;
  float* acc = smem + (1 + 2 * warp) * E * 32;
  const int h = a.h;
  const int chunks = h / CH;    // h % CH == 0 on the vector path
  const bool affine = a.w != nullptr;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const long long end = min(a.n, ((long long)blockIdx.x + 1) * a.rows);
  long long row = (long long)blockIdx.x * a.rows + warp;

  // the first row's loads go out before γ's
  typename C::Raw xv[NC], gv[NC], xn[kAhead ? NC : 1], gn[kAhead ? NC : 1];
  load_row<T, CH, NC>(xv, x + row * h, row < end, chunks, lane);
  load_row<T, CH, NC>(gv, g + row * h, row < end, chunks, lane);
  if (affine) {
    float tw[Stage<CH, NC>::N];
    Stage<CH, NC>::load(a.w, a.w_dtype, chunks, tw);
    Stage<CH, NC>::store(tw, smem);
#pragma unroll
    for (int j = 0; j < 2 * E; ++j) acc[j * 32 + lane] = 0.f;
  }
  __syncthreads();

#pragma unroll 1
  while (row < end) {
    const long long next = row + kWarps;
    if constexpr (kAhead) {
      load_row<T, CH, NC>(xn, x + next * h, next < end, chunks, lane);
      load_row<T, CH, NC>(gn, g + next * h, next < end, chunks, lane);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
#pragma unroll
      for (int j = 0; j < CH; ++j) s += C::get(xv[k], j);
    }
    const float mean = warp_sum(s) / (float)h;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (k * 32 + lane < chunks) {
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const float d = C::get(xv[k], j) - mean;
          q = fmaf(d, d, q);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)h + a.eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (k * 32 + lane >= chunks) continue;
      // a chunk's γ and slab words are read together, then written back
      float w[CH], ag[CH], ab[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int i = (k * CH + j) * 32 + lane;
        w[j] = affine ? sw[i] : 1.f;
        ag[j] = affine ? acc[i] : 0.f;
        ab[j] = affine ? acc[E * 32 + i] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float xh = (C::get(xv[k], j) - mean) * rstd;
        const float gg = C::get(gv[k], j);
        const float gw = gg * w[j];
        s1 += gw;
        s2 = fmaf(gw, xh, s2);
        ag[j] = fmaf(gg, xh, ag[j]);
        ab[j] += gg;
      }
      if (affine) {
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int i = (k * CH + j) * 32 + lane;
          acc[i] = ag[j];
          acc[E * 32 + i] = ab[j];
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / (float)h, m2 = s2 / (float)h;
    T* dr = dx + row * h;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * 32 + lane;
      if (c >= chunks) continue;
      float o[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int i = (k * CH + j) * 32 + lane;
        const float xh = (C::get(xv[k], j) - mean) * rstd;
        const float gg = C::get(gv[k], j);
        const float gw = affine ? gg * sw[i] : gg;
        o[j] = rstd * (gw - m1 - xh * m2);
      }
      C::store(dr + c * CH, o);
    }
    row = next;
    if constexpr (kAhead) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        xv[k] = xn[k];
        gv[k] = gn[k];
      }
    } else if (row < end) {
      load_row<T, CH, NC>(xv, x + row * h, true, chunks, lane);
      load_row<T, CH, NC>(gv, g + row * h, true, chunks, lane);
    }
  }
  if (!affine) return;

  // the block's partial: each column's slab entries in warp order
  __syncthreads();
  float* part = a.part + (long long)blockIdx.x * a.ld;
  for (int idx = threadIdx.x; idx < E * 32; idx += kThreads) {
    const int j = idx >> 5;
    const int c = (j / CH) * 32 + (idx & 31);
    if (c >= chunks) continue;
    const int col = c * CH + j % CH;
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* slab = smem + (1 + 2 * w) * E * 32;
      sg += slab[idx];
      sb += slab[E * 32 + idx];
    }
    part[col] = sg;
    part[h + col] = sb;
  }
  finish(a);
}

// the block's sums of a and b, the warps' sums added in warp order
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[kWarps]) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  float s = 0.f, t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    s += red[0][w];
    t += red[1][w];
  }
  __syncthreads();
  a = s;
  b = t;
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads) ln_bwd_block(const LnBwdArgs a) {
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ float red[2][kWarps];
  const int h = a.h;
  T* xs = reinterpret_cast<T*>(staged);
  T* gs = xs + h;
  const bool affine = a.w != nullptr;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  float* part = a.part + (long long)blockIdx.x * a.ld;
  if (affine) {
    for (int i = threadIdx.x; i < h; i += kThreads)
      part[i] = part[h + i] = 0.f;
  }
  const long long end = min(a.n, ((long long)blockIdx.x + 1) * a.rows);
  for (long long row = (long long)blockIdx.x * a.rows; row < end; ++row) {
    const T* xr = x + row * h;
    const T* gr = g + row * h;
    T* dr = dx + row * h;
    // a thread reads back only the elements it staged: no barrier needed
    // between the passes beyond the block sums'
    float s = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const T t = xr[i];
      if (STAGED) {
        xs[i] = t;
        gs[i] = gr[i];
      }
      s += to_f32(t);
    }
    const float mean = block_sum(s, red[0]) / (float)h;
    float q = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float d = to_f32(STAGED ? xs[i] : xr[i]) - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(block_sum(q, red[0]) / (float)h + a.eps);
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float xh = (to_f32(STAGED ? xs[i] : xr[i]) - mean) * rstd;
      const float gg = to_f32(STAGED ? gs[i] : gr[i]);
      const float gw = affine ? gg * load_param(a.w, a.w_dtype, i) : gg;
      s1 += gw;
      s2 = fmaf(gw, xh, s2);
      if (affine) {
        part[i] = fmaf(gg, xh, part[i]);
        part[h + i] += gg;
      }
    }
    block_sum2(s1, s2, red);
    const float m1 = s1 / (float)h, m2 = s2 / (float)h;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float xh = (to_f32(STAGED ? xs[i] : xr[i]) - mean) * rstd;
      const float gg = to_f32(STAGED ? gs[i] : gr[i]);
      const float gw = affine ? gg * load_param(a.w, a.w_dtype, i) : gg;
      dr[i] = from_f32<T>(rstd * (gw - m1 - xh * m2));
    }
  }
  if (affine) finish(a);
}

// Opts an instance into `smem` bytes of dynamic shared memory past 48 KB
// (beside its static shared memory), when it asks for more than before;
// 0 or the CUDA error.
template <typename K>
int opt_in(K kernel, size_t smem, size_t& opted) {
  if (smem <= (48 << 10) || smem <= opted) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err) opted = smem;
  return err;
}

template <typename T, int CH, int NC>
int launch_warp(const LnBwdArgs& a, cudaStream_t st) {
  constexpr int E = CH * NC;
  static size_t opted = 0;
  const size_t smem =
      a.w ? sizeof(float) * E * 32 * (1 + 2 * kWarps) : 0;
  const int err = opt_in(ln_bwd_warp<T, CH, NC>, smem, opted);
  if (err) return err;
  ln_bwd_warp<T, CH, NC><<<a.blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool STAGED>
int launch_block(const LnBwdArgs& a, cudaStream_t st) {
  static size_t opted = 0;
  const size_t smem = STAGED ? 2 * sizeof(T) * (size_t)a.h : 0;
  if (smem > (size_t)kMaxStagedBwd) return (int)cudaErrorInvalidValue;
  const int err = opt_in(ln_bwd_block<T, STAGED>, smem, opted);
  if (err) return err;
  ln_bwd_block<T, STAGED><<<a.blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const LnBwdArgs& a, int path, int epl, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (path == kStaged) return launch_block<T, true>(a, st);
  if (path == kStreamed) return launch_block<T, false>(a, st);
  if (epl * 32 < a.h) return (int)cudaErrorInvalidValue;
  if (path == kVector) {
    if (a.h % V) return (int)cudaErrorInvalidValue;
    switch (epl) {
      case 8: return launch_warp<T, V, 8 / V>(a, st);
      case 16: return launch_warp<T, V, 16 / V>(a, st);
      case 32: return launch_warp<T, V, 32 / V>(a, st);
      case 64: return launch_warp<T, V, 64 / V>(a, st);
    }
  } else if (path == kScalar) {
    switch (epl) {
      case 8: return launch_warp<T, 1, 8>(a, st);
      case 16: return launch_warp<T, 1, 16>(a, st);
      // f32 rows of one element a load past 512 take a block, as in the
      // forward
      case 32:
        if constexpr (sizeof(T) < 4) return launch_warp<T, 1, 32>(a, st);
        break;
      case 64:
        if constexpr (sizeof(T) < 4) return launch_warp<T, 1, 64>(a, st);
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One call's arguments as the wrapper packs them, every field 64 bits: dx
// (n, h) in x's dtype from g and x (n, h) of that dtype (0 f32, 1 bf16,
// 2 fp16); w (h,) in its own dtype, 0 for no affine; part, counters and
// out (the workspace: blocks·ld f32 with ld = 2·h rounded up to 4, and 2
// int32 all 0; out (2, h) f32), all 0 without affine. path and epl as
// apex_ln_fwd's (g's base 16-byte aligned too on the vector path); rows a
// block and blocks from layer_norm._ln_bwd_plan.
struct LnBwdCall {
  long long g, x, w, dx, part, counters, out, n, h, x_dtype, w_dtype, path,
      epl, rows, blocks;
  double eps;
};

// Launches on stream; returns the CUDA error code (0: launched).
extern "C" int apex_ln_bwd(const LnBwdCall* k, void* stream) {
  const long long n = k->n, h = k->h, rows = k->rows, blocks = k->blocks;
  const bool affine = k->w != 0;
  if (n <= 0 || h <= 0 || h > INT_MAX / 4 || rows <= 0 || blocks <= 0 ||
      blocks > INT_MAX || (blocks - 1) * rows >= n || blocks * rows < n ||
      (affine && (k->part == 0 || k->counters == 0 || k->out == 0 ||
                  blocks > kChunk * (kThreads / kSlots))))
    return (int)cudaErrorInvalidValue;
  const LnBwdArgs a{reinterpret_cast<const void*>(k->g),
                    reinterpret_cast<const void*>(k->x),
                    reinterpret_cast<const void*>(k->w),
                    reinterpret_cast<void*>(k->dx),
                    reinterpret_cast<float*>(k->part),
                    reinterpret_cast<int*>(k->counters),
                    reinterpret_cast<float*>(k->out), n, rows, (int)h,
                    (int)((2 * h + 3) / 4 * 4), (int)k->w_dtype, (int)blocks,
                    (float)k->eps};
  const int path = (int)k->path, epl = (int)k->epl;
  cudaStream_t st = (cudaStream_t)stream;
  if (k->x_dtype == kBF16) return dispatch<__nv_bfloat16>(a, path, epl, st);
  if (k->x_dtype == kF16) return dispatch<__half>(a, path, epl, st);
  if (k->x_dtype == kF32) return dispatch<float>(a, path, epl, st);
  return (int)cudaErrorInvalidValue;
}
