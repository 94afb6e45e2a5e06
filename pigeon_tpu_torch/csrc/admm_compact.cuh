// The code shared by the dense ADMM kernel's builds with A compact:
// csrc/admm_wide.cu (the wide build: the condensed QP's long rows and
// columns, a diagonal or a dense P) and csrc/admm_large.cu (the large
// build: the sparse coupled QP in the split modes and the sparse
// decoupled QP, one block filling an SM; and its pair build: an instance
// on two blocks, for a K^-1 that one block does not hold).  All replace
// the TPU kernel pigeon_tpu/solver/pallas_admm.py:_kernel and store A's
// static nonzeros once in row and once in column slot order, read by lane
// plans (the wrapper's `pallas_admm.EllPattern`).  Shared here: the
// precision modes' arithmetic (Arith, the bf16 pair in one 32-bit word,
// SplitSums), the
// NaN handling (clip_keep_nan, nmax), a lane's run and its group's sum,
// the check blocks with the early exit per tile (run_checks), and the host
// side of a launch for a build's traits (`prepare`, `launch`,
// `max_clusters`, `registers`).  The two sources compile in parallel (one
// nvcc each).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_MAX = 8;               // the portable cluster size
constexpr int SMEM_MAX = 232448;          // 227 KB: a block's opt-in limit
constexpr int SLOTS_MAX = 32767;          // int16 slots
constexpr unsigned FULL = 0xffffffffu;
// a lane's descriptor (pallas_admm.lane_plan): its segment (row or column;
// LANE_IDLE for none), its place g in the segment's group, the group's
// size G
constexpr int LANE_SEG = 0xffff;
constexpr int LANE_IDLE = 0xffff;
constexpr int LANE_G_SHIFT = 16;
constexpr int LANE_SIZE_SHIFT = 21;

// the precision modes, in the order of the wrapper's pallas_admm.MODES
enum Mode : int { HIGHEST = 0, MIXED = 1, MIXEDK6 = 2, HIGH = 3, BF16 = 4 };
constexpr int N_MODES = 5;

template <int MODE> struct Arith {
  static constexpr bool VEC = MODE != HIGHEST;
  static constexpr bool K_SPLIT = MODE == MIXED || MODE == HIGH;
  static constexpr bool K_ROUND = MODE == BF16;
  static constexpr bool A_MIXED = MODE == MIXED || MODE == MIXEDK6;
  // the A products carry the split sums
  static constexpr bool A_SPLIT = MODE == MIXED || MODE == MIXEDK6
                                  || MODE == HIGH;
};

struct Args {
  const float* __restrict__ Kinv;     // (B, n, n)
  const float* __restrict__ Aval;     // (B, sr + sc): row slots, column slots
  const int* __restrict__ plan;       // (plan_words) the pattern (`Smem`)
  const float* __restrict__ q;        // (B, n)
  const float* __restrict__ l;        // (B, m)
  const float* __restrict__ u;        // (B, m)
  const float* __restrict__ rho;      // (B, m)
  float* __restrict__ x;              // (B, n) in/out
  float* __restrict__ z;              // (B, m) in/out
  float* __restrict__ y;              // (B, m) in/out
  const float* __restrict__ E;        // (B, m)
  const float* __restrict__ PuD;      // (B, n), or (B, n, n) if dense_P
  const float* __restrict__ qu;       // (B, n)
  const float* __restrict__ invDc;    // (B, n)
  float* __restrict__ stats;          // (B, 8)
  int B, n, m, sr, sc, rwarps, cwarps, tile, n_iters, check, dense_P,
      m_eq;
  float sigma, alpha, eps_abs, eps_rel;
};

// K^-1's row stride: n rounded up to 8 mod 32
__host__ __device__ inline int kld(int n) { return n + ((8 - n) & 31); }

__host__ __device__ inline int even(int v) { return (v + 1) & ~1; }

// The pattern block (the wrapper's EllPattern.plan, one int32 tensor,
// copied whole): ints the row lane plan's descriptors and runs (32 rwarps
// each), the column lane plan's (32 cwarps each), then shorts rcol (sr
// row slots), crow (sc column slots), each rounded up to an even count, so
// every part is word aligned.
__host__ __device__ inline int plan_words(int sr, int sc, int rwarps,
                                          int cwarps) {
  return 64 * (rwarps + cwarps) + (even(sr) + even(sc)) / 2;
}

__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// clip(v, lo, hi) that keeps a NaN v, as jnp.clip and torch do
__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// A bf16 pair in one word: hi = bf16(v) in the upper 16 bits, lo =
// bf16(v - hi) in the lower (the TPU kernel's split, pallas_admm.py:131-132
// and :335-339)
__device__ __forceinline__ unsigned split_word(float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
  return ((unsigned)__bfloat16_as_ushort(hi) << 16)
         | (unsigned)__bfloat16_as_ushort(lo);
}

__device__ __forceinline__ float hi_of(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float lo_of(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a vector entry as the mode's products take it: the pair, or (BF16) the
// rounded value as hi and lo 0
template <int MODE>
__device__ __forceinline__ unsigned vec_word(float v) {
  if constexpr (MODE == BF16)
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v)) << 16;
  else
    return split_word(v);
}

// whether row r of A is split in this mode
template <int MODE>
__device__ __forceinline__ bool split_row(const Args& a, int r) {
  if constexpr (MODE == HIGH) return true;
  else if constexpr (Arith<MODE>::A_MIXED) return r >= a.m_eq;
  else return false;
}

// the vector operand of an unsplit term: v, or (BF16) its rounding
template <int MODE>
__device__ __forceinline__ float operand(const float* v, const unsigned* vw,
                                         int i) {
  if constexpr (MODE == BF16) return hi_of(vw[i]);
  else return v[i];
}

// the three sums of a split product, one term at a time
struct SplitSums {
  float hh = 0.0f, hl = 0.0f, lh = 0.0f;
  __device__ __forceinline__ void add(unsigned mw, unsigned vw) {
    hh = hh + hi_of(vw) * hi_of(mw);
    hl = hl + hi_of(vw) * lo_of(mw);
    lh = lh + lo_of(vw) * hi_of(mw);
  }
  // the TPU kernel's order: (v_hi M_hi + v_hi M_lo) + v_lo M_hi
  __device__ __forceinline__ float sum() const { return (hh + hl) + lh; }
};

// A lane's part of a segment: its segment (LANE_IDLE for none), its place
// g in the segment's group and the group's size G
struct Lane {
  int seg, g, G;
  __device__ __forceinline__ explicit Lane(int d)
      : seg(d & LANE_SEG), g((d >> LANE_G_SHIFT) & 31),
        G((d >> LANE_SIZE_SHIFT) & 63) {}
  __device__ __forceinline__ bool idle() const { return seg == LANE_IDLE; }
};

// The group's sum in its lane g = 0: lane g adds lane g + d's partial sum
// for d = 1, 2, 4, ... while g is a multiple of 2 d and g + d < G.  `span`
// (uniform across the warp) bounds the warp's group sizes.
__device__ __forceinline__ float group_sum(float v, const Lane& ln,
                                           int span) {
  for (int d = 1; d < span; d <<= 1) {
    const float t = __shfl_down_sync(FULL, v, d);
    if ((ln.g & (2 * d - 1)) == 0 && ln.g + d < ln.G) v = v + t;
  }
  return v;
}

__device__ __forceinline__ SplitSums group_sum(SplitSums sp, const Lane& ln,
                                               int span) {
  sp.hh = group_sum(sp.hh, ln, span);
  sp.hl = group_sum(sp.hl, ln, span);
  sp.lh = group_sum(sp.lh, ln, span);
  return sp;
}

// A lane's run of its segment's nonzeros (the segment's g-th run of
// ceil(len / G) consecutive nonzeros, none for an idle lane, planned by
// the wrapper), from its run word p | count << 16: slots p, p + 32, ...
__device__ __forceinline__ void lane_run(int run, int& p, int& end) {
  p = run & 0xffff;
  end = p + 32 * (run >> 16);
}

// The check blocks of a call, shared by the builds: `iter(last)` runs
// one iteration (`last`: the last before a check), `stats()` the check
// (uniform across the block).  Every `check` iterations (0 < check <
// n_iters) the tile (a cluster of `blocks` blocks: `tile`, or 2 `tile`
// in the pair build) stops once all its blocks have converged (blocks past
// B count as converged); the last check block runs only the remainder, so
// the executed count is exact.  check == 0 (or >= n_iters) runs n_iters
// and one check.  Returns the executed iterations.
template <class Iter, class Stats>
__device__ __forceinline__ int run_checks(const Args& a, int* flags,
                                          bool active, Iter iter,
                                          Stats stats, int blocks) {
  if (!(0 < a.check && a.check < a.n_iters)) {
    if (active) {
      for (int t = 0; t < a.n_iters; ++t) iter(t + 1 == a.n_iters);
      stats();
    }
    return a.n_iters;
  }
  const int n_blocks = (a.n_iters + a.check - 1) / a.check;
  const int lane = threadIdx.x % 32;
  int it = 0;
  bool done = false;
  while (!done && it < n_blocks) {           // uniform across the tile
    const int k_len = min(a.check, a.n_iters - it * a.check);
    bool conv = true;                        // blocks past B
    if (active) {
      for (int t = 0; t < k_len; ++t) iter(t + 1 == k_len);
      conv = stats();
    }
    if (blocks > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) flags[it & 1] = conv;
      cluster.sync();
      int all = 1;
      if (lane < blocks)
        all = *cluster.map_shared_rank(flags + (it & 1), lane);
      done = __all_sync(FULL, all) != 0;
    } else {
      done = conv;
    }
    ++it;
  }
  // no block leaves while another may still read its flags
  if (blocks > 1) cg::this_cluster().sync();
  return min(it * a.check, a.n_iters);
}

using KernelFn = void (*)(Args);

// `pairs` blocks an instance (2 in the pair build), so a tile is a cluster
// of pairs * tile blocks
cudaLaunchConfig_t launch_config(int B, int tile, size_t shmem,
                                 cudaLaunchAttribute* attr, void* stream,
                                 int threads, int pairs) {
  cudaLaunchConfig_t cfg = {};
  const int blocks = tile * pairs;          // a cluster
  cfg.gridDim = dim3((unsigned)(((B + tile - 1) / tile) * blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  return cfg;
}

// the mixed modes take 0 < m_eq <= m leading equality rows; the others
// m_eq == 0
bool valid_mode(int mode, int m_eq, int m) {
  if (mode < 0 || mode >= N_MODES) return false;
  return (mode == MIXED || mode == MIXEDK6) ? (0 < m_eq && m_eq <= m)
                                            : m_eq == 0;
}

// The host side of a build `Build`: Build::BLOCK (threads a block),
// Build::PAIRS (blocks an instance), Build::N_MAX (the largest n it
// takes), Build::smem(n, m, sr, sc, rwarps, cwarps, mode) (a block's
// shared bytes) and Build::kernel(dense_P, mode) (its kernel; nullptr
// where the build takes no such call).  `prepare` checks the arguments
// and the block's shared memory and sets its opt-in.
template <class Build>
cudaError_t prepare(int n, int m, int sr, int sc, int rwarps, int cwarps,
                    int tile, int dense_P, int mode, int m_eq,
                    size_t* shmem) {
  if (n < 1 || m < 1 || sr < 0 || sr > SLOTS_MAX || sc < 0
      || sc > SLOTS_MAX || n >= LANE_IDLE || n > Build::N_MAX
      || m >= LANE_IDLE || rwarps < 1 || cwarps < 1 || tile < 1
      || tile * Build::PAIRS > TILE_MAX || (dense_P != 0 && dense_P != 1)
      || !valid_mode(mode, m_eq, m) || !Build::kernel(dense_P, mode))
    return cudaErrorInvalidValue;
  *shmem = Build::smem(n, m, sr, sc, rwarps, cwarps, mode);
  if (*shmem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(Build::kernel(dense_P, mode),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*shmem);
}

template <class Build>
int launch(const Args& a, int mode, void* stream) {
  size_t shmem = 0;
  cudaError_t err = prepare<Build>(a.n, a.m, a.sr, a.sc, a.rwarps,
                                   a.cwarps, a.tile, a.dense_P, mode,
                                   a.m_eq, &shmem);
  if (err != cudaSuccess || a.n_iters < 0 || a.check < 0)
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  if (a.B <= 0) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(a.B, a.tile, shmem, attr,
                                               stream, Build::BLOCK,
                                               Build::PAIRS);
  err = cudaLaunchKernelEx(&cfg, Build::kernel(a.dense_P, mode), a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of a `tile` (Build::PAIRS tile blocks) the card holds
// at once
// (cudaOccupancyMaxActiveClusters), into *out
template <class Build>
int max_clusters(int n, int m, int sr, int sc, int rwarps, int cwarps,
                 int tile, int dense_P, int mode, int* out) {
  const int m_eq = (mode == MIXED || mode == MIXEDK6) ? 1 : 0;
  size_t shmem = 0;
  cudaError_t err = prepare<Build>(n, m, sr, sc, rwarps, cwarps, tile,
                                   dense_P, mode, m_eq, &shmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(tile, tile, shmem, attr, nullptr,
                                         Build::BLOCK, Build::PAIRS);
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, Build::kernel(dense_P, mode), &cfg);
}

// The registers a thread of the kernel for `mode` and `dense_P` uses
// (cudaFuncGetAttributes), into *out
template <class Build>
int registers(int mode, int dense_P, int* out) {
  if (mode < 0 || mode >= N_MODES || (dense_P != 0 && dense_P != 1)
      || !Build::kernel(dense_P, mode))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, Build::kernel(dense_P, mode));
  if (err != cudaSuccess) return (int)err;
  *out = attr.numRegs;
  return 0;
}

}  // namespace
