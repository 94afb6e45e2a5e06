// OSQP ADMM iterations of the hard MPC QPs with a dense explicit K^-1, the
// large build, a diagonal P: the sparse coupled QP (n = 193, m = 290, the
// 128 equality rows first) in the split modes ("mixed", "mixedk6",
// "high", "bf16"), and the sparse decoupled QP (n = 245, m = 395) in
// "highest", "mixedk6" and "bf16".  One 512-thread block holds an SM (128
// registers a thread), and the design makes that block use the whole SM.
// The early-exit tile of `tile` instances is one thread block cluster.
// `pallas_admm.plan_build` picks it for a diagonal P in a split mode at
// widths within NARROW_WIDTH_MAX, and `EllPattern.for_mode` for a diagonal
// P whose narrow block does not fit, where its block fits (n <= 256).
//
// Replaces the TPU kernel pigeon_tpu/solver/pallas_admm.py:_kernel in
// those modes.  The iteration, the statistics, the exits, the modes'
// arithmetic and the NaN handling are those of csrc/admm_wide.cu (the
// wide build), and A is stored in its compact slot orders, with the code
// the two share (csrc/admm_compact.cuh); `pallas_admm.class_lane_plan`
// plans the lanes.
//
// Why another build.  The narrow build (csrc/admm_dense.cu) spends ~8,900
// clocks an iteration in "mixedk6" on 10 warps, a third each in A'w, the
// K^-1 product and A x, on chains of one thread a row or column (PERF.md,
// its clock64 reading).  Here:
//   A'w, A x    each row, and each column's part of equality rows and of
//               split rows, a group of lanes (`lane_plan`'s chain length);
//               each lane warp holds one class, so a warp branches once,
//               a split run sums its three products (`run_split`), an
//               fp32 run its terms (`run_sum`: a row's in two interleaved
//               sums); a column's two parts meet in shared memory (ae, as)
//               and are added in one more pass, as the TPU kernel's matA
//               adds them.  A x's group leader updates its row's z, y, w.
//   rhs' K^-1   a warp 16 consecutive columns (one task a warp: n <=
//               256), a lane 4 of them (one 16-byte load a row) over one
//               of 8 parts of the rows (`lk_run`: no bank conflicts at row
//               stride kld(n)); the parts added in the xor butterfly; the
//               first kreg<MODE>() rows of a lane's part held in registers
//               for the call, loaded from device memory, and only the
//               other rows of each part stored in shared memory (`KGeom`),
//               so that a K^-1 of n = 245 fits the block.
//   checks      the words of x and y made by the iteration before (`last`),
//               the maxima folded where A x and A'y are made and reduced
//               over all warps.
// 512 threads: 1,024 and 768 measured no faster (the block is bound by the
// traffic of its shared-memory pipe, loads and shuffles alike, not by its
// warps), and 512 leaves 128 registers a thread for the K^-1 rows.
//
// Why a kernel of its own, not template parameters of the wide kernel.
// The two differ in every phase of the iteration, not in a constant, so a
// parameter would pick a different body for each product, the check and
// the load:
//   A'w         the wide kernel sums a column's nonzeros of both classes
//               in one lane group and branches on each term's row
//               (`split_row` in col_products: in the mixed modes the
//               condensed QP's column runs mix equality and split rows);
//               here a column's two classes are two groups, whose sums
//               meet in shared memory.  Planning the wide kernel's lanes
//               by class would change the condensed QP's sums, which keep
//               their bits (scripts/b8_parent_ab.py run holds them).
//   A x         one chain a lane there; two interleaved sums a row here
//               (run_sum<MODE, 2>).
//   rhs' K^-1   two columns (k, k + 8) a lane over one of 4 parts, scalar
//               loads, there; 4 consecutive columns a lane over one of 8
//               parts, 16-byte loads and kreg<MODE>() rows in registers
//               here, which needs one 512-thread block an SM (128
//               registers a thread); the wide kernel runs two 320-thread
//               blocks an SM (96).
//   checks      x and y split at the check and the maxima on one warp
//               there; made by the iteration before and reduced over all
//               warps here (LSmem's vnx and wmax against Smem's ax).
//
// The pair build (kernel "admm_pair"): an instance whose K^-1 does not fit
// one large block (n > 256, or the sparse decoupled QP's n = 245 in
// "mixed" and "high", whose 8 register rows leave 182 rows stored) runs on
// a pair of blocks, one an SM, in a cluster
// of 2 `tile` blocks (the tile's pairs).  K^-1 is symmetric, so block r of
// the pair holds the columns of its half of x (`KGeom`: a whole number of
// the product's 16-column tasks, block 0 half of them rounded up) over all
// n rows, at the row stride `pair_ld(n)` (8 mod 32, as kld).  Each block
// runs the whole iteration redundantly (A'w, the right-hand side, A x, the
// z and y updates, the checks), which makes the two blocks' vectors the
// same bits, and only its half of xt = rhs' K^-1; it stores that half in
// its own and its partner's exchange buffer (`xh`, distributed shared
// memory, double-buffered by the iteration's parity), and after a cluster
// barrier both relax all of x from the full xt.  So a check's statistics
// are the same in both blocks, and block 0 writes the outputs.  Blocks past
// B keep to the cluster barriers.  A column's sum is the large build's
// (the same row parts and order), so the pair gives the large build's
// bits; it stores all n rows of its columns.
//
// Bound on the card (H100 SXM): the larger of the call's bytes (K^-1 and
// A's static nonzeros read once) and its operations (a split term's three
// FMAs): 0.136 ms, by operations, for the sparse fleet's 2048-instance
// cold segment in "mixedk6"; its pipe floor, K^-1 through the
// shared-memory pipe once an iteration at 128 B a clock, 0.548 ms
// (chip_smoke.py's `pipe_floor_ms`, which counted all n rows before the
// register rows left shared memory).  What sets the time is the pipe's
// traffic: measured, it moves ~1.4 clocks a 128-byte wavefront in the
// K^-1 product, which keeps it near 2,000 clocks an iteration.

#include "admm_compact.cuh"

namespace {

// 16 warps: as fast as 24 or 32 on the sparse QP (the block is bound by
// its shared-memory traffic, not by its warps), and 128 registers a
// thread, so that part of K^-1 stays in registers (PERF.md)
constexpr int L_THREADS = 512;
constexpr int L_WARPS = L_THREADS / 32;
// rows of its part of K^-1 a K^-1 lane keeps in registers for the call:
// 16 where K^-1 is fp32 or rounded, 8 where its words are split
// (Arith<MODE>::K_SPLIT: 16 would spill the split sums' registers)
__host__ __device__ constexpr int kreg_of(int mode) {
  return (mode == MIXED || mode == HIGH) ? 8 : 16;
}

template <int MODE>
__host__ __device__ constexpr int kreg() {
  static_assert((kreg_of(MODE) == 8) == Arith<MODE>::K_SPLIT, "kreg");
  return kreg_of(MODE);
}
// the K^-1 product: a lane's 4 consecutive columns (one 16-byte load a
// row) over one of the 8 parts of the rows; a warp's 4 column lanes (16
// consecutive columns), the parts 4 lanes apart
constexpr int LK_PARTS = 8;
constexpr int LK_CLANES = 32 / LK_PARTS;
constexpr int LK_COLS = 4;
constexpr int LK_TASK = LK_CLANES * LK_COLS;
// a lane descriptor's class bit: its run is of split rows
constexpr int LANE_SPLIT = 1 << 27;

// A part's rows: runs of ceil(n / 8) rounded up to 2 mod 4, so that with
// the row stride kld(n) (8 mod 32) the two parts of a quarter warp read 16
// banks apart and its eight 16-byte loads fall in 32 banks
__host__ __device__ inline int lk_run(int n) {
  const int r = (n + LK_PARTS - 1) / LK_PARTS;
  return r + ((2 - r) & 3);
}

__host__ __device__ inline int lk_tasks(int n) {
  return (n + LK_TASK - 1) / LK_TASK;
}

// The large build's n: one K^-1 task a warp, so that every lane's first
// kreg rows are register rows and shared memory holds only the rest
constexpr int L_N_MAX = L_WARPS * LK_TASK;

// The rows of K^-1 the large build stores: each part's rows past its
// first kreg, part p's at p (lk_run(n) - kreg) onwards (so row j of part
// p, kreg or more into its part, is stored row j - (p + 1) kreg; a part's
// stored run is 2 mod 4 rows, as lk_run's, where it has one)
__host__ __device__ inline int stored_rows(int n, int kreg) {
  const int run = lk_run(n);
  int rows = 0;
  for (int p = 0; p < LK_PARTS; ++p) {
    const int past = (n - p * run < run ? n - p * run : run) - kreg;
    rows += past > 0 ? past : 0;
  }
  return rows;
}

// The pair build's K^-1 columns: block 0 the first pair_cols0(n), a whole
// number of LK_TASK-column tasks (half of them rounded up), block 1 the
// rest, each at the row stride pair_ld(n), pair_cols0(n) rounded up to 8
// mod 32
__host__ __device__ inline int pair_cols0(int n) {
  return (lk_tasks(n) + 1) / 2 * LK_TASK;
}

__host__ __device__ inline int pair_ld(int n) { return kld(pair_cols0(n)); }

// A block's columns of K^-1 in its shared memory: from c0, `cols` of
// them, at row stride ld; `rows` rows stored, and `skip`: 0 where all n
// are (the pair build), else the register rows each part leaves out
// (`stored_rows`)
struct KGeom {
  int c0, cols, ld, skip, rows;
};

template <int MODE, bool PAIR>
__host__ __device__ inline KGeom k_geom(int n, int half) {
  if constexpr (PAIR) {
    const int c1 = min(pair_cols0(n), n);    // block 0's columns end
    return half == 0 ? KGeom{0, c1, pair_ld(n), 0, n}
                     : KGeom{c1, n - c1, pair_ld(n), 0, n};
  } else {
    return {0, n, kld(n), kreg<MODE>(), stored_rows(n, kreg<MODE>())};
  }
}

// K^-1's words in a block's shared memory: its stored rows (`kreg`
// register rows a part left out) at row stride kld(n), or (`pair`) all
// rows of a half's columns at pair_ld(n) and the exchange buffers xh (2 n)
__host__ __device__ inline size_t k_words(int n, int pair, int kreg) {
  return pair ? (size_t)n * pair_ld(n) + 2 * (size_t)n
              : (size_t)stored_rows(n, kreg) * kld(n);
}

// Shared memory of one block in `mode`, in this order: K^-1 (first, so
// that its rows are 16-byte aligned; `k_words`); floats v1, x, v2, q, PuD,
// qu, invDc, ae, as (n each), z, y, w, rho, l, u, E (m each), st (8), the
// warps' maxima (8 a warp), aqu (4), vr (sr slots), vc (sc slots); in
// every mode but HIGHEST the words vn1, vn2, vnx (n each), vm1, vm2 (m
// each); ints flags (2); the pattern block.
__host__ __device__ inline size_t smem_bytes_large(int n, int m, int sr,
                                                   int sc, int rwarps,
                                                   int cwarps, int mode,
                                                   int pair) {
  const bool vec = mode != HIGHEST;
  const size_t words = k_words(n, pair, kreg_of(mode)) + 9 * (size_t)n
                       + 7 * (size_t)m + 8 + 8 * L_WARPS + 4 + (size_t)sr
                       + sc + (vec ? 3 * (size_t)n + 2 * (size_t)m : 0) + 2
                       + plan_words(sr, sc, rwarps, cwarps);
  return 4 * words;
}

struct LSmem {
  // ae, as: a column's equality and split sums of A'v (the mixed modes);
  // xh: the pair build's exchange buffers of xt (2 n)
  float *K, *xh, *v1, *x, *v2, *q, *PuD, *qu, *invDc, *ae, *as;
  float *z, *y, *w, *rho, *l, *u, *E, *st, *wmax, *aqu, *vr, *vc;
  // the words of rhs (vn1), xt (vn2), x at a check (vnx), w (vm1) and y
  // at a check (vm2)
  unsigned *vn1, *vn2, *vnx, *vm1, *vm2;
  int *flags, *rl, *rr, *cl, *cr;
  short *rcol, *crow;
};

__device__ LSmem carve_large(float* sh, const Args& a, bool vec,
                             bool pair, int kreg) {
  const int n = a.n, m = a.m;
  LSmem s;
  s.K = sh;
  s.xh = s.K + n * pair_ld(n);
  s.v1 = s.K + k_words(n, pair, kreg);
  s.x = s.v1 + n;
  s.v2 = s.x + n;
  s.q = s.v2 + n;
  s.PuD = s.q + n;
  s.qu = s.PuD + n;
  s.invDc = s.qu + n;
  s.ae = s.invDc + n;
  s.as = s.ae + n;
  s.z = s.as + n;
  s.y = s.z + m;
  s.w = s.y + m;
  s.rho = s.w + m;
  s.l = s.rho + m;
  s.u = s.l + m;
  s.E = s.u + m;
  s.st = s.E + m;
  s.wmax = s.st + 8;
  s.aqu = s.wmax + 8 * L_WARPS;
  s.vr = s.aqu + 4;
  s.vc = s.vr + a.sr;
  s.vn1 = reinterpret_cast<unsigned*>(s.vc + a.sc);
  s.vn2 = s.vn1 + (vec ? n : 0);
  s.vnx = s.vn2 + (vec ? n : 0);
  s.vm1 = s.vnx + (vec ? n : 0);
  s.vm2 = s.vm1 + (vec ? m : 0);
  s.flags = reinterpret_cast<int*>(s.vm2 + (vec ? m : 0));
  s.rl = s.flags + 2;                      // the pattern block
  s.rr = s.rl + 32 * a.rwarps;
  s.cl = s.rr + 32 * a.rwarps;
  s.cr = s.cl + 32 * a.cwarps;
  s.rcol = reinterpret_cast<short*>(s.cr + 32 * a.cwarps);
  s.crow = s.rcol + even(a.sr);
  return s;
}

// whether the lane's slots hold split words in this mode
template <int MODE>
__device__ __forceinline__ bool split_lane(int desc) {
  if constexpr (MODE == HIGH) return true;
  else if constexpr (Arith<MODE>::A_MIXED) return (desc & LANE_SPLIT) != 0;
  else return false;
}

// A lane's fp32 sum of its run (each slot's value times the vector's
// entry, `operand`), in SUMS interleaved partial sums (term i in sum i mod
// SUMS) added at the end: a row's in two (chains half as long), a column
// part's in one.  (A row's in four, or one, each missed one of
// chip_smoke.py's rounding-limited bars on the sparse fleet's mixedk6
// path; PERF.md)
template <int MODE, int SUMS>
__device__ __forceinline__ float run_sum(int p, int end, const float* val,
                                         const short* idx, const float* v,
                                         const unsigned* vw) {
  const auto term = [&](int q) {
    return val[q] * operand<MODE>(v, vw, idx[q]);
  };
  float s0 = 0.0f, s1 = 0.0f;
  if constexpr (SUMS == 2) {
    for (; p + 32 < end; p += 64) {
      s0 = s0 + term(p);
      s1 = s1 + term(p + 32);
    }
  }
#pragma unroll 4
  for (; p < end; p += 32) s0 = s0 + term(p);
  return SUMS == 2 ? s0 + s1 : s0;
}

// A lane's three sums of its run of split words
__device__ __forceinline__ SplitSums run_split(int p, int end,
                                               const float* val,
                                               const short* idx,
                                               const unsigned* vw) {
  SplitSums sp;
#pragma unroll 4
  for (; p < end; p += 32) sp.add(__float_as_uint(val[p]), vw[idx[p]]);
  return sp;
}

// out(seg, sum, part) for every segment of a lane plan (descriptors
// `desc`, runs `runs`, `nw` lane warps, slots `val` / `idx`) of the vector
// v (its words vw), in the mode's arithmetic: every lane sums its run
// (`run_sum`, `run_split`), then the group adds its lanes' sums in
// `group_sum`'s tree.  A segment is a row, or a column's part of the
// equality rows (part false) or of the split rows (true)
// (`pallas_admm.class_lane_plan`), and each lane warp takes one part: in
// the mixed modes, its terms are fp32 or split, so a warp branches once.
template <int MODE, bool ROWS, class Out>
__device__ __forceinline__ void large_products(int nw, const int* desc,
                                               const int* runs,
                                               const float* val,
                                               const short* idx,
                                               const float* v,
                                               const unsigned* vw, Out out) {
  using M = Arith<MODE>;
  const int lane = threadIdx.x & 31;
  for (int lw = threadIdx.x >> 5; lw < nw; lw += L_WARPS) {
    const int d = desc[lw * 32 + lane];
    const Lane ln(d);
    int p, end;
    lane_run(runs[lw * 32 + lane], p, end);
    // a warp's part is its lanes' (its idle lanes' bit is clear)
    const bool part = __any_sync(FULL, d & LANE_SPLIT) != 0;
    const bool split = M::A_MIXED ? part : M::A_SPLIT;
    const int span = __reduce_max_sync(FULL, ln.G);
    float sum;
    if (split) {
      sum = group_sum(run_split(p, end, val, idx, vw), ln, span).sum();
    } else {
      sum = group_sum(run_sum<MODE, ROWS ? 2 : 1>(p, end, val, idx, v, vw),
                      ln, span);
    }
    if (!ln.idle() && ln.g == 0) out(ln.seg, sum, part);
  }
}

// The sums over the 8 parts of a column, added in the xor butterfly (lanes
// 4, 8, then 16 apart): ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)),
// the same bits in every part
__device__ __forceinline__ float parts_sum_large(float v) {
#pragma unroll
  for (int d = LK_CLANES; d < 32; d <<= 1)
    v = v + __shfl_xor_sync(FULL, v, d);
  return v;
}

// The K^-1 words a lane keeps in registers for the call: the first
// kreg<MODE>() rows of its part of its warp's first task (zero past the
// run)
template <int MODE>
struct KCache {
  uint4 w[kreg<MODE>()];
};

// A lane's K^-1 task geometry: its part's rows [j0, j1) and its first
// column k0 of task t
struct LKLane {
  int part, j0, j1;
  __device__ __forceinline__ explicit LKLane(int n) {
    const int lane = threadIdx.x & 31;
    part = lane / LK_CLANES;
    j0 = min(part * lk_run(n), n);
    j1 = min(j0 + lk_run(n), n);
  }
  __device__ __forceinline__ int k0(int t) const {
    return t * LK_TASK + (threadIdx.x & 31) % LK_CLANES * LK_COLS;
  }
};

// a K^-1 entry in the mode's form: the bf16 pair, or (BF16) the rounding
template <int MODE>
__device__ __forceinline__ unsigned k_word(float v) {
  using M = Arith<MODE>;
  if constexpr (M::K_SPLIT) return split_word(v);
  else if constexpr (M::K_ROUND) return __float_as_uint(bf16_round(v));
  else return __float_as_uint(v);
}

// Loads the lane's register rows of instance b's K^-1 straight from device
// memory, in the mode's form (its rows at stride n there: scalar loads,
// once an instance); zero past the part's rows, past the block's columns
// and for a warp without a task
template <int MODE>
__device__ __forceinline__ void load_kcache(const Args& a, const KGeom& kg,
                                            long long b, KCache<MODE>& kc) {
  const int n = a.n, t = threadIdx.x >> 5;
  const LKLane lk(n);
  const int k0 = lk.k0(t);
  const bool task = t < lk_tasks(kg.cols);
  const float* Kb = a.Kinv + b * n * n + kg.c0 + k0;
#pragma unroll
  for (int i = 0; i < kreg<MODE>(); ++i) {
    const int j = lk.j0 + i;
    const bool row = task && j < lk.j1;
    unsigned w[LK_COLS];
#pragma unroll
    for (int c = 0; c < LK_COLS; ++c)
      w[c] = (row && k0 + c < kg.cols)
                 ? k_word<MODE>(__ldg(Kb + (long long)j * n + c)) : 0u;
    kc.w[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// xt = rhs' K^-1 in the mode's arithmetic for the block's columns `kg`,
// then out(k, xt[k]): warp t takes columns LK_TASK t onwards, a lane four
// of them over its part's rows ascending (the first kreg<MODE>() from
// registers on the warp's first task, the rest from shared memory: row j
// at stored row j - (part + 1) kg.skip, so a warp has one task wherever
// kg.skip > 0), the parts added by `parts_sum_large`; the lanes of parts
// 0..3 put the four columns (columns past the block's read the row's next
// words, and are dropped).
template <int MODE, class Out>
__device__ __forceinline__ void large_k_products(const Args& a,
                                                 const LSmem& s,
                                                 const KGeom& kg,
                                                 const KCache<MODE>& kc,
                                                 Out out) {
  using M = Arith<MODE>;
  const int n = a.n, ld4 = kg.ld / 4, warp = threadIdx.x >> 5;
  const LKLane lk(n);
  const int shift = (lk.part + 1) * kg.skip;
  for (int t = warp; t < lk_tasks(kg.cols); t += L_WARPS) {
    const int k0 = lk.k0(t);
    const uint4* K4 = reinterpret_cast<const uint4*>(s.K + k0);
    int j = lk.j0;
    float c[LK_COLS];
    if constexpr (M::K_SPLIT) {
      // the K^-1 words are bf16 pairs
      SplitSums sp[LK_COLS];
      const auto term = [&](uint4 kw, unsigned vj) {
        sp[0].add(kw.x, vj);
        sp[1].add(kw.y, vj);
        sp[2].add(kw.z, vj);
        sp[3].add(kw.w, vj);
      };
      if (t == warp) {
#pragma unroll
        for (int i = 0; i < kreg<MODE>(); ++i)
          term(kc.w[i], lk.j0 + i < lk.j1 ? s.vn1[lk.j0 + i] : 0u);
        j = min(lk.j0 + kreg<MODE>(), lk.j1);
      }
#pragma unroll 4
      for (; j < lk.j1; ++j) term(K4[(j - shift) * ld4], s.vn1[j]);
#pragma unroll
      for (int q = 0; q < LK_COLS; ++q) {
        sp[q].hh = parts_sum_large(sp[q].hh);
        sp[q].hl = parts_sum_large(sp[q].hl);
        sp[q].lh = parts_sum_large(sp[q].lh);
        c[q] = sp[q].sum();
      }
    } else {
      // fp32 (K^-1 and rhs rounded to bf16 in BF16)
      float acc[LK_COLS] = {0.0f, 0.0f, 0.0f, 0.0f};
      const auto vec = [&](int i) {
        if constexpr (M::K_ROUND) return hi_of(s.vn1[i]);
        else return s.v1[i];
      };
      const auto term = [&](uint4 kw, float vj) {
        acc[0] = acc[0] + vj * __uint_as_float(kw.x);
        acc[1] = acc[1] + vj * __uint_as_float(kw.y);
        acc[2] = acc[2] + vj * __uint_as_float(kw.z);
        acc[3] = acc[3] + vj * __uint_as_float(kw.w);
      };
      if (t == warp) {
#pragma unroll
        for (int i = 0; i < kreg<MODE>(); ++i)
          term(kc.w[i], lk.j0 + i < lk.j1 ? vec(lk.j0 + i) : 0.0f);
        j = min(lk.j0 + kreg<MODE>(), lk.j1);
      }
#pragma unroll 4
      for (; j < lk.j1; ++j) term(K4[(j - shift) * ld4], vec(j));
#pragma unroll
      for (int q = 0; q < LK_COLS; ++q) c[q] = parts_sum_large(acc[q]);
    }
    const int p = lk.part;
    const float xt = p == 0 ? c[0] : p == 1 ? c[1] : p == 2 ? c[2] : c[3];
    if (p < LK_COLS && k0 + p < kg.cols) out(kg.c0 + k0 + p, xt);
  }
}

// x's relaxation from xt[k], and in the modes with vector words those of
// xt and (`last`) of x
template <int MODE>
__device__ __forceinline__ void relax(const Args& a, const LSmem& s, int k,
                                      float xt, bool last) {
  const float al = a.alpha, om = 1.0f - a.alpha;
  s.v2[k] = xt;
  const float x = al * xt + om * s.x[k];
  s.x[k] = x;
  if constexpr (Arith<MODE>::VEC) {
    s.vn2[k] = vec_word<MODE>(xt);
    if (last) s.vnx[k] = vec_word<MODE>(x);
  }
}

// One iteration of the large build; s.w holds w on entry and on exit (and,
// in every mode but HIGHEST, s.vm1 its words).  `last`: the last iteration
// before a check, which also makes the words of x and y for its products.
// PAIR: the block's half of xt goes to its own and its partner's
// exchange buffer of parity `par` (`xh_peer`, the partner's xh), and after
// the cluster barrier the block relaxes all of x.
template <int MODE, bool PAIR>
__device__ __forceinline__ void iterate_large(const Args& a, const LSmem& s,
                                              const KGeom& kg,
                                              const KCache<MODE>& kc,
                                              bool last, int par,
                                              float* xh_peer) {
  using M = Arith<MODE>;
  // a column's parts, then its sum, as the TPU kernel's matA adds them
  large_products<MODE, false>(a.cwarps, s.cl, s.cr, s.vc, s.crow, s.w, s.vm1,
                              [&](int j, float sum, bool part) {
    (part ? s.as : s.ae)[j] = sum;
  });
  __syncthreads();
  for (int j = threadIdx.x; j < a.n; j += L_THREADS) {
    const float rhs = (a.sigma * s.x[j] - s.q[j]) + (s.ae[j] + s.as[j]);
    s.v1[j] = rhs;
    if constexpr (M::K_SPLIT || M::K_ROUND) s.vn1[j] = vec_word<MODE>(rhs);
  }
  __syncthreads();
  // xt = rhs' K^-1, and x's relaxation
  const float al = a.alpha, om = 1.0f - a.alpha;
  large_k_products<MODE>(a, s, kg, kc, [&](int k, float xt) {
    if constexpr (PAIR) {
      s.xh[par * a.n + k] = xt;
      xh_peer[par * a.n + k] = xt;
    } else {
      relax<MODE>(a, s, k, xt, last);
    }
  });
  if constexpr (PAIR) {
    cg::this_cluster().sync();
    for (int k = threadIdx.x; k < a.n; k += L_THREADS)
      relax<MODE>(a, s, k, s.xh[par * a.n + k], last);
  }
  __syncthreads();
  // zt = A xt, and in the same lane the row's z, y and next w
  large_products<MODE, true>(a.rwarps, s.rl, s.rr, s.vr, s.rcol, s.v2, s.vn2,
                             [&](int r, float zt, bool) {
    const float rho = s.rho[r];
    const float zm = al * zt + om * s.z[r];
    const float zn = clip_keep_nan(zm + s.y[r] * (1.0f / rho), s.l[r],
                                   s.u[r]);
    const float yn = s.y[r] + rho * (zm - zn);
    s.y[r] = yn;
    s.z[r] = zn;
    const float w = rho * zn - yn;          // the next iteration's
    s.w[r] = w;
    if constexpr (M::VEC) {
      s.vm1[r] = vec_word<MODE>(w);
      if (last) s.vm2[r] = vec_word<MODE>(yn);
    }
  });
  __syncthreads();
}

// Unscaled statistics of the block's instance into s.st; returns whether
// it has converged (uniform across the block).  A x and A'y through the
// mode's products (x's words in vnx, y's in vm2, made by the iteration
// before); a row's group leader folds its row's terms into its lane's
// maxima, a column's terms fold in the pass that adds its two parts; each
// warp reduces its lanes' maxima, and warp 0 the warps'.
template <int MODE>
__device__ bool calc_stats_large(const Args& a, const LSmem& s) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f, s5 = 0.0f;
  large_products<MODE, true>(a.rwarps, s.rl, s.rr, s.vr, s.rcol, s.x, s.vnx,
                             [&](int r, float ax, bool) {
    const float invE = 1.0f / s.E[r];
    const float Ax_u = ax * invE;
    const float z_u = s.z[r] * invE;
    s0 = nmax(s0, fabsf(Ax_u - z_u));
    s2 = nmax(s2, fabsf(Ax_u));
    s3 = nmax(s3, fabsf(z_u));
  });
  large_products<MODE, false>(a.cwarps, s.cl, s.cr, s.vc, s.crow, s.y, s.vm2,
                              [&](int j, float sum, bool part) {
    (part ? s.as : s.ae)[j] = sum;
  });
  __syncthreads();
  for (int j = threadIdx.x; j < a.n; j += L_THREADS) {
    const float Px_u = s.PuD[j] * s.x[j];
    const float qu = s.qu[j];
    const float Aty_u = (s.ae[j] + s.as[j]) * s.invDc[j];
    s1 = nmax(s1, fabsf(Px_u + qu + Aty_u));
    s4 = nmax(s4, fabsf(Px_u));
    s5 = nmax(s5, fabsf(Aty_u));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float part[6] = {s0, s1, s2, s3, s4, s5};
#pragma unroll
  for (int i = 0; i < 6; ++i) part[i] = warp_max(part[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) s.wmax[warp * 8 + i] = part[i];
  }
  __syncthreads();
  bool conv = true;
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
      part[i] = warp_max(lane < L_WARPS ? s.wmax[lane * 8 + i] : 0.0f);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 6; ++i) s.st[i] = part[i];
      s.st[6] = 0.0f;
      s.st[7] = 0.0f;
    }
    const float eps_p = a.eps_abs + a.eps_rel * nmax(part[2], part[3]);
    const float eps_d = a.eps_abs
                        + a.eps_rel * nmax(nmax(part[4], part[5]), s.aqu[0]);
    conv = (part[0] <= eps_p) && (part[1] <= eps_d);
  }
  return __syncthreads_and(conv) != 0;
}

// Loads the block's instance b: the stored rows `kg` of its K^-1 (its
// columns in the pair build), A's values, the pattern block and the
// vectors.
template <int MODE>
__device__ void load_large(const Args& a, const LSmem& s, const KGeom& kg,
                           long long b) {
  using M = Arith<MODE>;
  const int n = a.n, m = a.m, ld = kg.ld, nc = kg.cols;
  const int srun = lk_run(n) - kg.skip;     // > 0 wherever a row is stored
  const float* Kb = a.Kinv + b * n * n + kg.c0;
  for (int e = threadIdx.x; e < kg.rows * nc; e += L_THREADS) {
    const int i = e / nc, c = e - i * nc;
    // stored row i: row i + (part + 1) skip of K^-1
    const int j = kg.skip ? i + (i / srun + 1) * kg.skip : i;
    cp_async4(s.K + i * ld + c, Kb + (long long)j * n + c);
  }
  const float* Vb = a.Aval + b * (a.sr + a.sc);
  for (int e = threadIdx.x; e < a.sr + a.sc; e += L_THREADS)
    cp_async4(s.vr + e, Vb + e);             // vc follows vr
  const int pw = plan_words(a.sr, a.sc, a.rwarps, a.cwarps);
  for (int e = threadIdx.x; e < pw; e += L_THREADS)
    cp_async4(s.rl + e, a.plan + e);
  for (int j = threadIdx.x; j < n; j += L_THREADS) {
    cp_async4(s.x + j, a.x + b * n + j);
    cp_async4(s.q + j, a.q + b * n + j);
    cp_async4(s.PuD + j, a.PuD + b * n + j);
    cp_async4(s.qu + j, a.qu + b * n + j);
    cp_async4(s.invDc + j, a.invDc + b * n + j);
  }
  for (int r = threadIdx.x; r < m; r += L_THREADS) {
    cp_async4(s.z + r, a.z + b * m + r);
    cp_async4(s.y + r, a.y + b * m + r);
    cp_async4(s.rho + r, a.rho + b * m + r);
    cp_async4(s.l + r, a.l + b * m + r);
    cp_async4(s.u + r, a.u + b * m + r);
    cp_async4(s.E + r, a.E + b * m + r);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // the mode's forms of K^-1 and A (a slot's class is its lane's; the
  // pads' forms are never read)
  if constexpr (M::K_SPLIT || M::K_ROUND) {
    for (int e = threadIdx.x; e < kg.rows * nc; e += L_THREADS) {
      float* k = s.K + (e / nc) * ld + e % nc;
      *k = M::K_SPLIT ? __uint_as_float(split_word(*k)) : bf16_round(*k);
    }
  }
  if constexpr (M::VEC) {
    const int lanes = 32 * (a.rwarps + a.cwarps);
    for (int e = threadIdx.x; e < lanes; e += L_THREADS) {
      const bool row = e < 32 * a.rwarps;
      const int d = row ? s.rl[e] : s.cl[e - 32 * a.rwarps];
      int p, end;
      lane_run(row ? s.rr[e] : s.cr[e - 32 * a.rwarps], p, end);
      float* vals = row ? s.vr : s.vc;
      for (; p < end; p += 32) {
        if (split_lane<MODE>(d))
          vals[p] = __uint_as_float(split_word(vals[p]));
        else if (MODE == BF16)
          vals[p] = bf16_round(vals[p]);
      }
    }
  }
  for (int r = threadIdx.x; r < m; r += L_THREADS) {
    const float w = s.rho[r] * s.z[r] - s.y[r];
    s.w[r] = w;
    if constexpr (M::VEC) {
      s.vm1[r] = vec_word<MODE>(w);
      s.vm2[r] = vec_word<MODE>(s.y[r]);
    }
  }
  for (int j = threadIdx.x; j < n; j += L_THREADS) {
    s.ae[j] = 0.0f;                          // a column without the part
    s.as[j] = 0.0f;
    if constexpr (M::VEC) s.vnx[j] = vec_word<MODE>(s.x[j]);
  }
  if (threadIdx.x < 32) {                    // max |q_u|, for the checks
    float aqu = 0.0f;
    for (int j = threadIdx.x; j < n; j += 32) aqu = nmax(aqu, fabsf(s.qu[j]));
    aqu = warp_max(aqu);
    if (threadIdx.x == 0) s.aqu[0] = aqu;
  }
  __syncthreads();
}

// MODE: the precision mode (`Mode`); a diagonal P.  PAIR: the pair build,
// blocks 2 b and 2 b + 1 (ranks r and r ^ 1 of the cluster) on instance b
template <int MODE, bool PAIR>
__global__ void __launch_bounds__(L_THREADS, 1)
admm_large_kernel(Args a) {
  extern __shared__ float4 sh4[];
  const LSmem s = carve_large(reinterpret_cast<float*>(sh4), a,
                              Arith<MODE>::VEC, PAIR, kreg<MODE>());
  const long long b = PAIR ? blockIdx.x / 2 : blockIdx.x;
  const int half = PAIR ? blockIdx.x % 2 : 0;
  const KGeom kg = k_geom<MODE, PAIR>(a.n, half);
  const bool active = b < a.B;               // uniform across the pair
  KCache<MODE> kc;
  if (active) {
    load_kcache<MODE>(a, kg, b, kc);
    load_large<MODE>(a, s, kg, b);
  }
  float* xh_peer = nullptr;
  if constexpr (PAIR) {
    // every block of the cluster has started before the first remote store
    cg::cluster_group cluster = cg::this_cluster();
    xh_peer = cluster.map_shared_rank(s.xh, (int)(cluster.block_rank() ^ 1));
    cluster.sync();
  }
  int par = 0;
  // a pair past B keeps to the iterations' cluster barriers
  const int executed = run_checks(
      a, s.flags, PAIR || active,
      [&](bool last) {
        if (active) iterate_large<MODE, PAIR>(a, s, kg, kc, last, par,
                                              xh_peer);
        else if (PAIR) cg::this_cluster().sync();
        par ^= 1;
      },
      [&] { return !active || calc_stats_large<MODE>(a, s); },
      PAIR ? 2 * a.tile : a.tile);
  if (!active || half != 0) return;
  if (threadIdx.x == 0) s.st[6] = (float)executed;
  __syncthreads();
  for (int j = threadIdx.x; j < a.n; j += L_THREADS)
    a.x[b * a.n + j] = s.x[j];
  for (int r = threadIdx.x; r < a.m; r += L_THREADS) {
    a.z[b * a.m + r] = s.z[r];
    a.y[b * a.m + r] = s.y[r];
  }
  if (threadIdx.x < 8) a.stats[b * 8 + threadIdx.x] = s.st[threadIdx.x];
}

template <int MODE, bool PAIR>
constexpr KernelFn of_mode() {
  return &admm_large_kernel<MODE, PAIR>;
}

// the builds' traits (csrc/admm_compact.cuh's `prepare`): a diagonal P
// only; an instance a block (Large, n <= L_N_MAX) or a pair of blocks
// (Pair)
template <bool PAIR>
struct LargeBuild {
  static constexpr int BLOCK = L_THREADS;
  static constexpr int PAIRS = PAIR ? 2 : 1;
  static constexpr int N_MAX = PAIR ? LANE_IDLE - 1 : L_N_MAX;
  static size_t smem(int n, int m, int sr, int sc, int rwarps, int cwarps,
                     int mode) {
    return smem_bytes_large(n, m, sr, sc, rwarps, cwarps, mode, PAIR);
  }
  static KernelFn kernel(int dense_P, int mode) {
    if (dense_P) return nullptr;
    switch (mode) {
      case HIGHEST: return of_mode<HIGHEST, PAIR>();
      case MIXED: return of_mode<MIXED, PAIR>();
      case MIXEDK6: return of_mode<MIXEDK6, PAIR>();
      case HIGH: return of_mode<HIGH, PAIR>();
      case BF16: return of_mode<BF16, PAIR>();
    }
    return nullptr;
  }
};
using Large = LargeBuild<false>;
using Pair = LargeBuild<true>;

}  // namespace

// x, z and y are updated in place (the wrapper passes fresh copies).
// PuD is P's diagonal (B, n); dense_P must be 0.  mode: `Mode`; m_eq the
// leading equality rows of the mixed modes (0 for the others).
extern "C" int admm_large_f32(
    const float* Kinv, const float* Aval, const int* plan, const float* q,
    const float* l, const float* u, const float* rho, float* x, float* z,
    float* y, const float* E, const float* PuD, const float* qu,
    const float* invDc, float* stats, int B, int n, int m, int sr, int sc,
    int rwarps, int cwarps, int tile, int n_iters, int dense_P, int mode,
    int m_eq, float sigma, float alpha, int check, float eps_abs,
    float eps_rel, void* stream) {
  const Args a{Kinv, Aval, plan, q, l, u, rho, x, z, y, E, PuD, qu, invDc,
               stats, B, n, m, sr, sc, rwarps, cwarps, tile, n_iters, check,
               dense_P, m_eq, sigma, alpha, eps_abs, eps_rel};
  return launch<Large>(a, mode, stream);
}

// How many clusters of `tile` blocks of this kernel the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int admm_large_max_clusters(int n, int m, int sr, int sc,
                                       int rwarps, int cwarps, int tile,
                                       int dense_P, int mode, int* out) {
  return max_clusters<Large>(n, m, sr, sc, rwarps, cwarps, tile, dense_P,
                             mode, out);
}

// The registers a thread of the build for `mode` uses
// (cudaFuncGetAttributes), into *out.
extern "C" int admm_large_registers(int mode, int dense_P, int* out) {
  return registers<Large>(mode, dense_P, out);
}

// The pair build: the same arguments, an instance on a pair of blocks, a
// tile of at most TILE_MAX / 2 instances.
extern "C" int admm_pair_f32(
    const float* Kinv, const float* Aval, const int* plan, const float* q,
    const float* l, const float* u, const float* rho, float* x, float* z,
    float* y, const float* E, const float* PuD, const float* qu,
    const float* invDc, float* stats, int B, int n, int m, int sr, int sc,
    int rwarps, int cwarps, int tile, int n_iters, int dense_P, int mode,
    int m_eq, float sigma, float alpha, int check, float eps_abs,
    float eps_rel, void* stream) {
  const Args a{Kinv, Aval, plan, q, l, u, rho, x, z, y, E, PuD, qu, invDc,
               stats, B, n, m, sr, sc, rwarps, cwarps, tile, n_iters, check,
               dense_P, m_eq, sigma, alpha, eps_abs, eps_rel};
  return launch<Pair>(a, mode, stream);
}

// How many clusters of a `tile` (2 tile blocks) of the pair build the card
// holds at once, into *out.
extern "C" int admm_pair_max_clusters(int n, int m, int sr, int sc,
                                      int rwarps, int cwarps, int tile,
                                      int dense_P, int mode, int* out) {
  return max_clusters<Pair>(n, m, sr, sc, rwarps, cwarps, tile, dense_P,
                            mode, out);
}

extern "C" int admm_pair_registers(int mode, int dense_P, int* out) {
  return registers<Pair>(mode, dense_P, out);
}
