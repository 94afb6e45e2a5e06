// OSQP ADMM iterations of the hard MPC QPs with a dense explicit K^-1
// (five precision modes, a diagonal or a dense P): one thread block per
// instance, its K^-1 and the nonzeros of its A resident in shared memory
// for the whole call, and the early-exit tile of `tile` instances one
// thread block cluster.
//
// Replaces the TPU kernel pigeon_tpu/solver/pallas_admm.py:_kernel in all
// its modes, with a diagonal P (the sparse QP) or a dense one (`dense_P`,
// the condensed QP).  Per iteration (instance-local, scaled problem):
//   w  = rho z - y,  rhs = sigma x - q + A'w,  xt = rhs' K^-1,  zt = A xt
//   x <- alpha xt + (1 - alpha) x
//   zm = alpha zt + (1 - alpha) z,  z <- clip(zm + y (1/rho), l, u)
//   y <- y + rho (zm - z)
// Every `check` iterations (0 < check < n_iters) each instance computes
// its unscaled statistics (r_prim, r_dual, max|Ax|, max|z|, max|Px|,
// max|A'y|) with A x and A'y against the scaled matrix and the scalings
// (1/E, P_u D, q_u, 1/(D c)), and the tile stops once every instance of
// it has converged.  The tile is semantics, not tiling: it is the TPU
// kernel's grid step, whose early exit takes all instances of the step.
// The last check block runs only the remainder of n_iters, so the
// executed count (stats column 6) is exact.  check == 0 (or >= n_iters)
// runs a fixed n_iters.
//
// P enters only the statistics, as P_u x_u = x_bar' (D P_u): with a
// diagonal P the wrapper passes the vector P_u D and the product is
// elementwise; with a dense P (`dense_P`) it passes the (n x n) matrix
// PuD = D[:, None] P_u, which the block holds in shared memory beside K^-1
// (42,436 B at the condensed QP's n = 103; loaded once per call with
// cp.async, as K^-1 is, where reading it from L2 at every check would
// move it again at each of a segment's checks), and each check forms
// x_bar' PuD with a thread per column, rows ascending, in the K^-1
// product's fixed order.  The diagonal build's shared memory and
// arithmetic are unchanged by the dense mode.
//
// Precision modes (`MODE`, a template parameter beside DENSE_P; one
// build each, ten in all).  Every product is v M, and the modes differ in
// its arithmetic, as the TPU kernel's (pallas_admm.py:124-158):
//   HIGHEST  fp32 products and sums;
//   BF16     M and v rounded to bfloat16 (to nearest even), the exact
//            products summed in fp32 (the precision ladder's bulk phase);
//   HIGH     every product split: v_hi = bf16(v), v_lo = bf16(v - v_hi),
//            M_hi, M_lo likewise, and v M ~ (v_hi M_hi + v_hi M_lo) +
//            v_lo M_hi, three fp32 sums of exact products;
//   MIXED    the split for the rows r >= m_eq of A (the inequality rows;
//            the caller puts the m_eq equality rows first) and for K^-1,
//            fp32 for the equality rows; A'v = fp32 part + split part;
//   MIXEDK6  as MIXED with K^-1 in fp32.
// The statistics take A x and A'y through the same products; a dense P's
// x' PuD stays fp32 in every mode.  A split matrix word keeps its bf16
// pair (hi in the upper 16 bits, lo in the lower) in the 32 bits of the
// fp32 value it replaces, so K^-1 and the row-ELL values take the same
// shared memory in every mode: the block splits (or rounds) them where it
// loads them, and the wrapper's packed A is the same for every mode.
// Each vector is split once per product, into one word an entry in
// shared memory (4 (2 n + 2 m) bytes more than HIGHEST: 3,876 B at the
// sparse QP's n = 193, m = 290).  On the TPU the split saved MXU passes;
// on these CUDA cores it costs three FMAs (and two masks) where HIGHEST
// spends one, on every split nonzero of A and, in MIXED and HIGH, on every
// entry of K^-1: the same dependent chains, three times the issue.  BF16
// costs what HIGHEST does.  So HIGHEST and BF16 are bound as below (the
// shared-memory pipe and the products' latency), the split modes by
// that plus the split terms' FMA issue and each vector's split, made
// where the vector is produced (at a check, one more pass and barrier).
//
// Residency.  Each block loads its instance's K^-1 (n x n; 148,996 B at
// n = 193) with cp.async once per call, and A as its nonzeros: a row-ELL
// of values (m x W, W = 11 at m = 290) packed by the wrapper with one
// gather, beside the pattern shared by every instance (a code per
// row-ELL slot, and a column-ELL of row-ELL slots, Wc = 15), plus the
// vectors.  ~196 KB at n = 193, m = 290 (`smem_bytes`, mirrored by
// pallas_admm.smem_bytes); a shape over the 227 KB a block may use is
// refused (n > 211 at this m).  The condensed QP (n = 103, m = 200, W =
// 39, Wc = 79) takes 146,712 B, 189,148 B with its dense P.  Each
// instance's matrices are read from device memory once per call, not once
// per iteration.
//
// Products, each in the summation order of the first (streaming) design,
// so skipping A's zeros leaves every sum's rounding unchanged:
//   A'w    a thread per column, its nonzeros in ascending row;
//   xt     a thread per column k of K^-1, read row by row (consecutive
//          threads read consecutive words), j ascending;
//   A x    a thread per row: the first design's warp per row summed
//          lane l's columns j = l, l + 32, ... in ascending order, then
//          added the lanes' sums in the xor butterfly's tree; the thread
//          adds the same sums in the same tree without the absent lanes
//          (`mat_vec`).  The row-ELL is ordered for it.
//
// The tile is a cluster of `tile` blocks (1..8, portable), launched with
// cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension; the grid is
// padded to whole tiles and blocks past B hold no data and vote
// "converged".  At each check every block writes its instance's
// convergence into its shared memory, one barrier.cluster, and every
// block reads the tile's flags through distributed shared memory; the
// flags are double-buffered by check index, so one cluster barrier per
// check is enough.  tile == 1 launches no cluster.
//
// Bound on the card (H100 SXM): the call must read K^-1 and A's nonzeros
// once (0.16 MB per instance at the path's shapes, 0.33 GB at B = 2048:
// ~0.1 ms of device memory), and do per iteration 2 n^2 + 4 nnz(A)
// operations (~0.08 MFLOP per instance).  The first design streamed K^-1
// once and the dense A twice per iteration from device memory (0.6 MB per
// instance and iteration) and read 28.87 ms per 50-iteration cold segment
// at B = 2048 (PERF.md).  Here the shared-memory pipe and its latency
// set the time: per iteration the K^-1 product's n^2 loads (149 KB, ~1,160
// clocks at 128 B a clock) and the dependent loads of A x and A'w.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// ten warps: the row loops (A x, the z and y update) take the path's m =
// 290 rows in one pass
constexpr int THREADS = 320;
// a row slot's code (the wrapper's EllPattern.row_code): its column, the
// merges after it, whether it starts and whether it ends its lane's sum
constexpr int CODE_COL = 0xffff;
constexpr int CODE_MERGE_SHIFT = 16;
constexpr int CODE_FIRST = 1 << 19;
constexpr int CODE_LAST = 1 << 20;
constexpr int TILE_MAX = 8;               // the portable cluster size
constexpr int SMEM_MAX = 232448;          // 227 KB: a block's opt-in limit
constexpr unsigned FULL = 0xffffffffu;

// the precision modes, in the order of the wrapper's pallas_admm.MODES
enum Mode : int { HIGHEST = 0, MIXED = 1, MIXEDK6 = 2, HIGH = 3, BF16 = 4 };
constexpr int N_MODES = 5;

// what each mode does: vectors split (or rounded) into shared memory; K^-1
// split or rounded; A's rows from m_eq on split (MIXED*), all split, or all
// rounded
template <int MODE> struct Arith {
  static constexpr bool VEC = MODE != HIGHEST;
  static constexpr bool K_SPLIT = MODE == MIXED || MODE == HIGH;
  static constexpr bool K_ROUND = MODE == BF16;
  static constexpr bool A_MIXED = MODE == MIXED || MODE == MIXEDK6;
};

struct Args {
  const float* __restrict__ Kinv;     // (B, n, n)
  const float* __restrict__ Aval;     // (B, m, W) row-ELL values
  const int* __restrict__ rcode;      // (m, W) code of each slot, -1 pad
  const short* __restrict__ cslot;    // (n, Wc) row-ELL slots, -1 pad
  const short* __restrict__ crow;     // (n, Wc) their rows
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
  int B, n, m, W, Wc, tile, n_iters, check, dense_P, m_eq;
  float sigma, alpha, eps_abs, eps_rel;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared memory of one block, in this order: floats v1 (n rounded up to 4,
// 16-byte aligned for float4 reads); with `vec` (every mode but HIGHEST)
// the words vn1 (n rounded up to 4, uint4 reads); the row-ELL as (value,
// code) pairs (m W float2); floats x, v2, q, PuD, qu,
// invDc (n each), z, y, w, ax, rho, l, u, E (m each), st (8), K^-1 (n n),
// and with a dense P the matrix PuD (n n); with `vec` the words vn2 (n),
// vm1, vm2 (m each); int flags (2); shorts cslot, crow (n Wc each).
__host__ __device__ inline size_t smem_bytes(int n, int m, int W, int Wc,
                                             int dense_P, int vec) {
  const size_t floats = 6 * (size_t)n + 8 * (size_t)m + 8 + (size_t)n * n
                        + (dense_P ? (size_t)n * n : 0);
  const size_t words = vec ? (size_t)round4(n) + n + 2 * (size_t)m : 0;
  return 4 * (size_t)round4(n) + 8 * (size_t)m * W
         + 4 * floats + 8 + 4 * (size_t)n * Wc + 4 * words;
}

struct Smem {
  float *v1, *x, *v2, *q, *PuD, *qu, *invDc;
  float *z, *y, *w, *ax, *rho, *l, *u, *E, *st, *K, *P;
  float2* vc;
  // a vector's bf16 split (or rounding) for the next product, one word an
  // entry: vn1 the rhs (K^-1), vn2 xt or x (A x), vm1 w (A'w), vm2 y (A'y)
  unsigned *vn1, *vn2, *vm1, *vm2;
  int* flags;
  short *cslot, *crow;
};

__device__ Smem carve(float* sh, int n, int m, int W, int Wc, int dense_P,
                      bool vec) {
  Smem s;
  s.v1 = sh;
  s.vn1 = reinterpret_cast<unsigned*>(s.v1 + round4(n));
  s.vc = reinterpret_cast<float2*>(s.vn1 + (vec ? round4(n) : 0));
  s.x = reinterpret_cast<float*>(s.vc + m * W);
  s.v2 = s.x + n;
  s.q = s.v2 + n;
  s.PuD = s.q + n;
  s.qu = s.PuD + n;
  s.invDc = s.qu + n;
  s.z = s.invDc + n;
  s.y = s.z + m;
  s.w = s.y + m;
  s.ax = s.w + m;
  s.rho = s.ax + m;
  s.l = s.rho + m;
  s.u = s.l + m;
  s.E = s.u + m;
  s.st = s.E + m;
  s.K = s.st + 8;
  s.P = s.K + n * n;                      // the dense PuD, if dense_P
  s.vn2 = reinterpret_cast<unsigned*>(s.P + (dense_P ? n * n : 0));
  s.vm1 = s.vn2 + (vec ? n : 0);
  s.vm2 = s.vm1 + (vec ? m : 0);
  s.flags = reinterpret_cast<int*>(s.vm2 + (vec ? m : 0));
  s.cslot = reinterpret_cast<short*>(s.flags + 2);
  s.crow = s.cslot + n * Wc;
  return s;
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
// bf16(v - hi) in the lower, both rounded to nearest even (the TPU
// kernel's split, pallas_admm.py:131-132 and :335-339).  A bf16 value is
// the upper half of the float it widens to, so unpacking is a mask or a
// shift.
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

// out[j] = sum_r A[r][j] v[r], a thread per column, ascending r (the
// column's pads, -1, come last); `vw` the mode's words of v.  The mixed
// modes' equality rows (r < m_eq) sum apart in fp32, and their sum is
// added to the split rows' (the TPU kernel's matA)
template <int MODE>
__device__ __forceinline__ float col_dot(const Args& a, const Smem& s, int j,
                                         const float* v, const unsigned* vw) {
  const short* slots = s.cslot + j * a.Wc;
  const short* rows = s.crow + j * a.Wc;
  float acc = 0.0f;
  SplitSums sp;
#pragma unroll 5
  for (int p = 0; p < a.Wc; ++p) {
    const int slot = slots[p];
    if (slot < 0) continue;
    const int r = rows[p];
    if (split_row<MODE>(a, r))
      sp.add(__float_as_uint(s.vc[slot].x), vw[r]);
    else
      acc = acc + s.vc[slot].x * operand<MODE>(v, vw, r);
  }
  if constexpr (MODE == HIGHEST || MODE == BF16) return acc;
  else return acc + sp.sum();
}

// out[r] = sum_j A[r][j] v[j], a thread per row.  The first design summed
// a row with a warp: lane l over the columns j = l, l + 32, ... in
// ascending order, then the xor butterfly, which adds the lanes' partial
// sums in a balanced binary tree over the lanes in bit-reversed order.
// Leaving out the zeros changes none of those additions but drops the
// ones with an absent lane, so the thread walks the row's slots in
// (bit-reversed lane, col) order, sums each lane's slots, pushes each
// lane's sum on a stack of six registers and merges the top two as many
// times as the slot's code says (the pruned tree in post-order, planned
// by the wrapper's EllPattern).  A split row (`split_row`) sums its three
// products over its slots in that order without the tree.
template <int MODE>
__device__ __forceinline__ void mat_vec(const Args& a, const Smem& s,
                                        const float* v, const unsigned* vw,
                                        float* out) {
  for (int r = threadIdx.x; r < a.m; r += THREADS) {
    const float2* e = s.vc + r * a.W;
    if (split_row<MODE>(a, r)) {
      SplitSums sp;
      for (int p = 0; p < a.W; ++p) {
        const float2 ep = e[p];
        const int code = __float_as_int(ep.y);
        if (code < 0) break;
        sp.add(__float_as_uint(ep.x), vw[code & CODE_COL]);
      }
      out[r] = sp.sum();
      continue;
    }
    float acc = 0.0f, t0 = 0.0f, t1 = 0.0f, t2 = 0.0f, t3 = 0.0f, t4 = 0.0f,
          t5 = 0.0f;
    for (int p = 0; p < a.W; ++p) {
      const float2 ep = e[p];
      const int code = __float_as_int(ep.y);
      if (code < 0) break;                    // the row's pads come last
      if (code & CODE_FIRST) acc = 0.0f;
      acc = acc + ep.x * operand<MODE>(v, vw, code & CODE_COL);
      if (code & CODE_LAST) {
        t5 = t4; t4 = t3; t3 = t2; t2 = t1; t1 = t0; t0 = acc;
        const int merges = (code >> CODE_MERGE_SHIFT) & 7;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          if (k < merges) {
            t0 = t1 + t0; t1 = t2; t2 = t3; t3 = t4; t4 = t5;
          }
        }
      }
    }
    out[r] = t0;
  }
}

// w = rho z - y of the current iterate
__device__ __forceinline__ float w_of(const Smem& s, int r) {
  return s.rho[r] * s.z[r] - s.y[r];
}

// One iteration; s.w holds w on entry and on exit (and, in every mode but
// HIGHEST, s.vm1 its words).
template <int MODE>
__device__ void iterate(const Args& a, const Smem& s) {
  using M = Arith<MODE>;
  const int n = a.n, m = a.m;
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const float rhs = (a.sigma * s.x[j] - s.q[j])
                      + col_dot<MODE>(a, s, j, s.w, s.vm1);
    s.v1[j] = rhs;
    if constexpr (M::K_SPLIT || M::K_ROUND) s.vn1[j] = vec_word<MODE>(rhs);
  }
  __syncthreads();
  // xt = rhs' K^-1 (thread per column k), and x's relaxation
  const float al = a.alpha, om = 1.0f - a.alpha;
  const float4* rhs4 = reinterpret_cast<const float4*>(s.v1);
  const uint4* rw4 = reinterpret_cast<const uint4*>(s.vn1);
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const float* Kk = s.K + k;
    float acc = 0.0f;
    int j = 0;
    if constexpr (M::K_SPLIT) {
      // the K^-1 words are bf16 pairs
      const unsigned* Kw = reinterpret_cast<const unsigned*>(Kk);
      SplitSums sp;
#pragma unroll 4
      for (; j + 4 <= n; j += 4) {
        const uint4 r4 = rw4[j >> 2];
        sp.add(Kw[j * n], r4.x);
        sp.add(Kw[(j + 1) * n], r4.y);
        sp.add(Kw[(j + 2) * n], r4.z);
        sp.add(Kw[(j + 3) * n], r4.w);
      }
      for (; j < n; ++j) sp.add(Kw[j * n], s.vn1[j]);
      acc = sp.sum();
    } else if constexpr (M::K_ROUND) {
      // K^-1 and rhs rounded to bf16
#pragma unroll 4
      for (; j + 4 <= n; j += 4) {
        const uint4 r4 = rw4[j >> 2];
        acc = acc + hi_of(r4.x) * Kk[j * n];
        acc = acc + hi_of(r4.y) * Kk[(j + 1) * n];
        acc = acc + hi_of(r4.z) * Kk[(j + 2) * n];
        acc = acc + hi_of(r4.w) * Kk[(j + 3) * n];
      }
      for (; j < n; ++j) acc = acc + hi_of(s.vn1[j]) * Kk[j * n];
    } else {
#pragma unroll 4
      for (; j + 4 <= n; j += 4) {
        const float4 r4 = rhs4[j >> 2];
        acc = acc + r4.x * Kk[j * n];
        acc = acc + r4.y * Kk[(j + 1) * n];
        acc = acc + r4.z * Kk[(j + 2) * n];
        acc = acc + r4.w * Kk[(j + 3) * n];
      }
      for (; j < n; ++j) acc = acc + s.v1[j] * Kk[j * n];
    }
    s.v2[k] = acc;
    if constexpr (M::VEC) s.vn2[k] = vec_word<MODE>(acc);
    s.x[k] = al * acc + om * s.x[k];
  }
  __syncthreads();
  mat_vec<MODE>(a, s, s.v2, s.vn2, s.w);    // zt, in place of w
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += THREADS) {
    const float rho = s.rho[r];
    const float zm = al * s.w[r] + om * s.z[r];
    const float zn = clip_keep_nan(zm + s.y[r] * (1.0f / rho), s.l[r], s.u[r]);
    s.y[r] = s.y[r] + rho * (zm - zn);
    s.z[r] = zn;
    s.w[r] = w_of(s, r);                    // the next iteration's
    if constexpr (M::VEC) s.vm1[r] = vec_word<MODE>(s.w[r]);
  }
  __syncthreads();
}

// Unscaled statistics of the block's instance into s.st (warp 0); returns
// whether it has converged (uniform across the block).  A x and A'y take
// the mode's products (x's words in vn2, y's in vm2).  With a dense P,
// P_u x_u = x_bar' PuD goes to v2 (free between iterations), a thread per
// column k, rows ascending, fp32 in every mode.
template <bool DENSE_P, int MODE>
__device__ bool calc_stats(const Args& a, const Smem& s) {
  const int n = a.n, m = a.m;
  if constexpr (Arith<MODE>::VEC) {
    for (int j = threadIdx.x; j < n; j += THREADS)
      s.vn2[j] = vec_word<MODE>(s.x[j]);
    for (int r = threadIdx.x; r < m; r += THREADS)
      s.vm2[r] = vec_word<MODE>(s.y[r]);
    __syncthreads();
  }
  mat_vec<MODE>(a, s, s.x, s.vn2, s.ax);            // A x
  for (int j = threadIdx.x; j < n; j += THREADS) {  // A'y (and P x)
    s.v1[j] = col_dot<MODE>(a, s, j, s.y, s.vm2);
    if constexpr (DENSE_P) {
      const float* Pk = s.P + j;
      float acc = 0.0f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) acc = acc + s.x[i] * Pk[i * n];
      s.v2[j] = acc;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bool conv = true;
  if (warp == 0) {
    float s0 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int r = lane; r < m; r += 32) {
      const float invE = 1.0f / s.E[r];
      const float Ax_u = s.ax[r] * invE;
      const float z_u = s.z[r] * invE;
      s0 = nmax(s0, fabsf(Ax_u - z_u));
      s2 = nmax(s2, fabsf(Ax_u));
      s3 = nmax(s3, fabsf(z_u));
    }
    float s1 = 0.0f, s4 = 0.0f, s5 = 0.0f, aqu = 0.0f;
    for (int j = lane; j < n; j += 32) {
      float Px_u;
      if constexpr (DENSE_P) Px_u = s.v2[j];
      else Px_u = s.PuD[j] * s.x[j];
      const float qu = s.qu[j];
      const float Aty_u = s.v1[j] * s.invDc[j];
      s1 = nmax(s1, fabsf(Px_u + qu + Aty_u));
      s4 = nmax(s4, fabsf(Px_u));
      s5 = nmax(s5, fabsf(Aty_u));
      aqu = nmax(aqu, fabsf(qu));
    }
    s0 = warp_max(s0); s1 = warp_max(s1); s2 = warp_max(s2);
    s3 = warp_max(s3); s4 = warp_max(s4); s5 = warp_max(s5);
    aqu = warp_max(aqu);
    if (lane == 0) {
      s.st[0] = s0; s.st[1] = s1; s.st[2] = s2; s.st[3] = s3;
      s.st[4] = s4; s.st[5] = s5; s.st[6] = 0.0f; s.st[7] = 0.0f;
    }
    const float eps_p = a.eps_abs + a.eps_rel * nmax(s2, s3);
    const float eps_d = a.eps_abs + a.eps_rel * nmax(nmax(s4, s5), aqu);
    conv = (s0 <= eps_p) && (s1 <= eps_d);
  }
  return __syncthreads_and(conv) != 0;
}

template <bool DENSE_P, int MODE>
__device__ void load(const Args& a, const Smem& s, long long b) {
  using M = Arith<MODE>;
  const int n = a.n, m = a.m, W = a.W, Wc = a.Wc;
  const float* Kb = a.Kinv + b * n * n;
  for (int e = threadIdx.x; e < n * n; e += THREADS) cp_async4(s.K + e, Kb + e);
  if constexpr (DENSE_P) {
    const float* Pb = a.PuD + b * n * n;
    for (int e = threadIdx.x; e < n * n; e += THREADS)
      cp_async4(s.P + e, Pb + e);
  }
  const float* Vb = a.Aval + b * m * W;
  for (int e = threadIdx.x; e < m * W; e += THREADS)
    cp_async4(&s.vc[e].x, Vb + e);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int e = threadIdx.x; e < m * W; e += THREADS)
    s.vc[e].y = __int_as_float(a.rcode[e]);
  for (int e = threadIdx.x; e < n * Wc; e += THREADS) {
    s.cslot[e] = a.cslot[e];
    s.crow[e] = a.crow[e];
  }
  for (int j = threadIdx.x; j < n; j += THREADS) {
    s.x[j] = a.x[b * n + j];
    s.q[j] = a.q[b * n + j];
    if constexpr (!DENSE_P) s.PuD[j] = a.PuD[b * n + j];
    s.qu[j] = a.qu[b * n + j];
    s.invDc[j] = a.invDc[b * n + j];
  }
  for (int r = threadIdx.x; r < m; r += THREADS) {
    s.z[r] = a.z[b * m + r];
    s.y[r] = a.y[b * m + r];
    s.rho[r] = a.rho[b * m + r];
    s.l[r] = a.l[b * m + r];
    s.u[r] = a.u[b * m + r];
    s.E[r] = a.E[b * m + r];
  }
  asm volatile("cp.async.wait_all;\n" ::);
  // the mode's forms of K^-1 and A, each thread on the words it copied
  if constexpr (M::K_SPLIT || M::K_ROUND) {
    for (int e = threadIdx.x; e < n * n; e += THREADS)
      s.K[e] = M::K_SPLIT ? __uint_as_float(split_word(s.K[e]))
                          : bf16_round(s.K[e]);
  }
  if constexpr (M::VEC) {
    for (int e = threadIdx.x; e < m * W; e += THREADS) {
      const float v = s.vc[e].x;
      if (split_row<MODE>(a, e / W))
        s.vc[e].x = __uint_as_float(split_word(v));
      else if (MODE == BF16)
        s.vc[e].x = bf16_round(v);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += THREADS) {
    s.w[r] = w_of(s, r);
    if constexpr (M::VEC) s.vm1[r] = vec_word<MODE>(s.w[r]);
  }
  __syncthreads();
}

// DENSE_P: P is the dense (n x n) PuD; false, the diagonal build.  MODE:
// the precision mode (`Mode`)
template <bool DENSE_P, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
admm_dense_kernel(Args a) {
  extern __shared__ float4 sh4[];
  const Smem s = carve(reinterpret_cast<float*>(sh4), a.n, a.m, a.W, a.Wc,
                       a.dense_P, Arith<MODE>::VEC);
  const long long b = blockIdx.x;
  const bool active = b < a.B;               // uniform across the block
  if (active) load<DENSE_P, MODE>(a, s, b);

  int executed;
  if (0 < a.check && a.check < a.n_iters) {
    const int n_blocks = (a.n_iters + a.check - 1) / a.check;
    const int lane = threadIdx.x % 32;
    int it = 0;
    bool done = false;
    while (!done && it < n_blocks) {         // uniform across the tile
      const int k_len = min(a.check, a.n_iters - it * a.check);
      bool conv = true;                      // blocks past B
      if (active) {
        for (int t = 0; t < k_len; ++t) iterate<MODE>(a, s);
        conv = calc_stats<DENSE_P, MODE>(a, s);
      }
      if (a.tile > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        if (threadIdx.x == 0) s.flags[it & 1] = conv;
        cluster.sync();
        int all = 1;
        if (lane < a.tile)
          all = *cluster.map_shared_rank(s.flags + (it & 1), lane);
        done = __all_sync(FULL, all) != 0;
      } else {
        done = conv;
      }
      ++it;
    }
    executed = min(it * a.check, a.n_iters);
    // no block leaves while another may still read its flags
    if (a.tile > 1) cg::this_cluster().sync();
  } else {
    if (active) {
      for (int t = 0; t < a.n_iters; ++t) iterate<MODE>(a, s);
      calc_stats<DENSE_P, MODE>(a, s);
    }
    executed = a.n_iters;
  }
  if (!active) return;
  if (threadIdx.x == 0) s.st[6] = (float)executed;
  __syncthreads();
  for (int j = threadIdx.x; j < a.n; j += THREADS) a.x[b * a.n + j] = s.x[j];
  for (int r = threadIdx.x; r < a.m; r += THREADS) {
    a.z[b * a.m + r] = s.z[r];
    a.y[b * a.m + r] = s.y[r];
  }
  if (threadIdx.x < 8) a.stats[b * 8 + threadIdx.x] = s.st[threadIdx.x];
}

cudaLaunchConfig_t launch_config(int B, int tile, size_t shmem,
                                 cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((B + tile - 1) / tile) * tile));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)tile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = tile > 1 ? 1 : 0;
  return cfg;
}

using KernelFn = void (*)(Args);

template <bool DENSE_P>
KernelFn of_mode(int mode) {
  switch (mode) {
    case HIGHEST: return admm_dense_kernel<DENSE_P, HIGHEST>;
    case MIXED: return admm_dense_kernel<DENSE_P, MIXED>;
    case MIXEDK6: return admm_dense_kernel<DENSE_P, MIXEDK6>;
    case HIGH: return admm_dense_kernel<DENSE_P, HIGH>;
    case BF16: return admm_dense_kernel<DENSE_P, BF16>;
  }
  return nullptr;
}

KernelFn kernel_of(int dense_P, int mode) {
  return dense_P ? of_mode<true>(mode) : of_mode<false>(mode);
}

// the mixed modes take 0 < m_eq <= m leading equality rows; the others
// m_eq == 0
bool valid_mode(int mode, int m_eq, int m) {
  if (mode < 0 || mode >= N_MODES) return false;
  return (mode == MIXED || mode == MIXEDK6) ? (0 < m_eq && m_eq <= m)
                                            : m_eq == 0;
}

cudaError_t prepare(int n, int m, int W, int Wc, int tile, int dense_P,
                    int mode, int m_eq, size_t* shmem) {
  if (n < 1 || m < 1 || W < 1 || Wc < 1 || tile < 1 || tile > TILE_MAX
      || (long long)m * W > 32767 || (dense_P != 0 && dense_P != 1)
      || !valid_mode(mode, m_eq, m))
    return cudaErrorInvalidValue;
  *shmem = smem_bytes(n, m, W, Wc, dense_P, mode != HIGHEST);
  if (*shmem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel_of(dense_P, mode),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*shmem);
}

}  // namespace

// x, z and y are updated in place (the wrapper passes fresh copies).
// PuD is (B, n), or (B, n, n) when dense_P is 1.  mode: `Mode`; m_eq the
// leading equality rows of the mixed modes (0 for the others).
extern "C" int admm_dense_f32(
    const float* Kinv, const float* Aval, const int* rcode,
    const short* cslot, const short* crow,
    const float* q, const float* l, const float* u, const float* rho,
    float* x, float* z, float* y, const float* E, const float* PuD,
    const float* qu, const float* invDc, float* stats, int B, int n, int m,
    int W, int Wc, int tile, int n_iters, int dense_P, int mode, int m_eq,
    float sigma, float alpha, int check, float eps_abs, float eps_rel,
    void* stream) {
  size_t shmem = 0;
  cudaError_t err = prepare(n, m, W, Wc, tile, dense_P, mode, m_eq, &shmem);
  if (err != cudaSuccess || n_iters < 0 || check < 0)
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Args a{Kinv, Aval, rcode, cslot, crow, q, l, u, rho, x, z, y, E,
         PuD, qu, invDc, stats, B, n, m, W, Wc, tile, n_iters, check,
         dense_P, m_eq, sigma, alpha, eps_abs, eps_rel};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, tile, shmem, attr, stream);
  err = cudaLaunchKernelEx(&cfg, kernel_of(dense_P, mode), a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `tile` blocks of this kernel the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int admm_dense_max_clusters(int n, int m, int W, int Wc, int tile,
                                       int dense_P, int mode, int* out) {
  const int m_eq = (mode == MIXED || mode == MIXEDK6) ? 1 : 0;
  size_t shmem = 0;
  cudaError_t err = prepare(n, m, W, Wc, tile, dense_P, mode, m_eq, &shmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(tile, tile, shmem, attr, nullptr);
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel_of(dense_P, mode),
                                             &cfg);
}

// The registers a thread of the build for `mode` and `dense_P` uses
// (cudaFuncGetAttributes), into *out.
extern "C" int admm_dense_registers(int mode, int dense_P, int* out) {
  if (mode < 0 || mode >= N_MODES || (dense_P != 0 && dense_P != 1))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr,
                                                kernel_of(dense_P, mode));
  if (err != cudaSuccess) return (int)err;
  *out = attr.numRegs;
  return 0;
}
