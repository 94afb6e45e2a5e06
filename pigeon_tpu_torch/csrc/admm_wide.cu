// OSQP ADMM iterations of the hard MPC QPs with a dense explicit K^-1, the
// build for a constraint matrix A with long rows or columns (the condensed
// QP's: rows up to 39 nonzeros, columns up to 79): one thread block per
// instance, its K^-1 and A's nonzeros resident in shared memory for the
// whole call, and the early-exit tile of `tile` instances one thread block
// cluster.  Five precision modes, a diagonal or a dense P, as
// csrc/admm_dense.cu (the narrow build, which the sparse QP keeps in mode
// "highest"); csrc/admm_large.cu (the large build) takes the sparse QP in
// the split modes.  What the builds with a compact A share is in
// csrc/admm_compact.cuh.
//
// Replaces the TPU kernel pigeon_tpu/solver/pallas_admm.py:_kernel in all
// its modes.  The iteration, the statistics, the early exit per tile, the
// exact executed count, the precision modes' arithmetic (Arith, SplitSums,
// the bf16 pair in one 32-bit word, each vector split once per product)
// and the NaN handling (clip_keep_nan, nmax) are the narrow build's; see
// its header.  What differs is how the block computes the three products
// v M, and how it stores A.
//
// Why a second build.  The narrow build keeps the summation order of the
// first (streaming) design: one thread per column for A'w (a dependent
// chain as long as the column), one per row for A x, one per column of
// K^-1 for rhs' K^-1.  On the condensed QP (n = 103, m = 200) that leaves
// 103 of 320 threads on 79-link chains in A'w and 103-link chains in the
// K^-1 product, and its row-ELL pads 3,105 nonzeros to 7,800 slots.  This
// build gives up that order:
//
// A, compact and sliced.  The nonzeros of the static pattern (shared by
// every instance) once for the row products (values `vr`, int16 columns)
// and once for the column products (values `vc`, int16 rows), each stored
// in the order its lanes read them: the i-th nonzero of lane l of lane
// warp w at slot base_w + 32 i + l, so a warp's 32 loads of a value or an
// index fall on consecutive words (the lanes' runs end unevenly: the
// slots after a run's end are pads, never read).  3,456 and 3,360 slots
// for the condensed QP's 3,105 nonzeros, 6 bytes a slot, 40,896 B (the
// narrow build's row-ELL and column-ELL take 94,948 B).  The wrapper packs
// both with one gather (`pallas_admm.pack`); the indices and the lane
// plans come in one int32 block (`plan_words`).  Every load of the block
// is a cp.async, so it waits for device memory once.
//
// Products, every thread at work, a fixed order (so a call repeats its
// bits; no atomics):
//   A'v and A v   each column (row) a group of G contiguous lanes of one
//                 warp (G in 1..32, from its length): lane g sums the g-th
//                 run of ceil(len / G) consecutive nonzeros of the
//                 segment in ascending order (neighbours, which cancel in
//                 the condensed A, stay in one running sum), then the
//                 group adds its lanes' sums in a tree
//                 (`group_sum`: lanes g and g + d for d = 1, 2, 4, ...,
//                 lane g + d's sum to lane g's).  The groups are packed
//                 into "lane warps" by the wrapper (`pallas_admm.
//                 lane_plan`: G = ceil(len / L) for the chain length L of
//                 least estimated latency; at the condensed shapes L = 20,
//                 G = 2 a long row, 4 a long column, 9 and 7 lane warps);
//                 warp w runs lane warps w, w + 10, ..., lane l's run at
//                 its slot and every 32nd after it.  A split mode
//                 reduces each of its three (four in the mixed modes'
//                 columns) sums so, and adds them as the narrow build does.
//   rhs' K^-1     a warp takes 16 columns, two a lane (k and k + 8), four
//                 lanes each: lane part p sums the p-th run of `k_run(n)`
//                 consecutive j (27 at n = 103) ascending, so the 103
//                 columns take 7 warps once; the four parts add in the xor
//                 butterfly, (s0 + s1) + (s2 + s3) in every lane.  K^-1's
//                 rows are stored `kld(n)` floats apart (n rounded up to 8
//                 mod 32) and the run is odd, so the warp's 32 loads fall
//                 in 32 banks.  x_bar' PuD at a check is the same product.
// A v's group leader also updates its row's z, y and w, so an iteration
// has three barriers (A'w | K^-1 | A xt and the update).
//
// Residency.  A block takes 97,164 B at the condensed QP's shapes (9 row
// and 7 column lane warps; `smem_bytes`, mirrored by pallas_admm.
// smem_bytes_wide), two blocks an SM.  A dense P's PuD (n x n) is read
// from device memory at each check (coalesced: eight consecutive columns a
// quarter warp); held in shared memory beside K^-1 it took one block an
// SM and measured 1.61x slower on the card (PERF.md).
// __launch_bounds__(320, 2): at most 96 registers.
//
// No tensor cores: each instance has its own K^-1 and A and each product
// is one matrix times one vector, so there is no tile for wgmma to take,
// and TF32 would change "highest"'s fp32 products.
//
// Bound on the card (H100 SXM): the call reads each instance's K^-1 (and a
// dense P) and A's static nonzeros once (not the two slot orders this
// build stores), 0.0647 ms for the condensed fleet's 2048-instance cold
// segment; per iteration it does 2 n^2 + 4 nnz(A)
// operations.  What sets the time is shared memory: per iteration the
// K^-1 product's n kld(n) loads and three loads a nonzero of A (value,
// index, the vector's entry) in each of the two A products, two blocks
// sharing an SM's pipe, each block's phases separated by barriers; and,
// at tile 1, the chains' latency (chip_smoke.py's latency floor).  A
// K^-1 product in 8 row runs of 13 (half the chain) measured no faster
// on the card, so the 4 runs stay.

#include "admm_compact.cuh"

namespace {

constexpr int THREADS = 320;
constexpr int WARPS = THREADS / 32;
// the K^-1 product: a warp task's 8 lanes of columns, 4 parts each, two
// columns (k and k + 8) a lane
constexpr int K_COLS = 8;
constexpr int K_PARTS = 4;
constexpr int K_TASK = 2 * K_COLS;

// Shared memory of one block, in this order: floats v1, x, v2, q, PuD, qu,
// invDc (n each), z, y, w, ax, rho, l, u, E (m each), st (8), K^-1 (n
// kld(n)), vr (sr slots), vc (sc slots); with `vec` the words vn1, vn2 (n
// each), vm1, vm2 (m each); ints flags (2); the pattern block.
__host__ __device__ inline size_t smem_bytes(int n, int m, int sr, int sc,
                                             int rwarps, int cwarps,
                                             int vec) {
  const size_t mat = (size_t)n * kld(n);
  const size_t words = 7 * (size_t)n + 8 * (size_t)m + 8 + mat
                       + (size_t)sr + sc
                       + (vec ? 2 * (size_t)n + 2 * (size_t)m : 0) + 2
                       + plan_words(sr, sc, rwarps, cwarps);
  return 4 * words;
}

struct Smem {
  float *v1, *x, *v2, *q, *PuD, *qu, *invDc;
  float *z, *y, *w, *ax, *rho, *l, *u, *E, *st, *K, *vr, *vc;
  // a vector's bf16 split (or rounding) for the next product, one word an
  // entry: vn1 the rhs (K^-1), vn2 xt or x (A v), vm1 w (A'w), vm2 y (A'y)
  unsigned *vn1, *vn2, *vm1, *vm2;
  // the lane plans: a lane's descriptor (rl, cl) and its run (rr, cr)
  int *flags, *rl, *rr, *cl, *cr;
  short *rcol, *crow;
};

__device__ Smem carve(float* sh, const Args& a, bool vec) {
  const int n = a.n, m = a.m, mat = n * kld(n);
  Smem s;
  s.v1 = sh;
  s.x = s.v1 + n;
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
  s.vr = s.K + mat;
  s.vc = s.vr + a.sr;
  s.vn1 = reinterpret_cast<unsigned*>(s.vc + a.sc);
  s.vn2 = s.vn1 + (vec ? n : 0);
  s.vm1 = s.vn2 + (vec ? n : 0);
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

// out(j, sum_r A[r][j] v[r]) for every column j, by the column lane plan;
// `vw` the mode's words of v.  The mixed modes' equality rows (r < m_eq)
// sum apart in fp32, and their sum is added to the split rows' (the TPU
// kernel's matA)
template <int MODE, class Out>
__device__ __forceinline__ void col_products(const Args& a, const Smem& s,
                                             const float* v,
                                             const unsigned* vw, Out out) {
  const int lane = threadIdx.x & 31;
  for (int lw = threadIdx.x >> 5; lw < a.cwarps; lw += WARPS) {
    const Lane ln(s.cl[lw * 32 + lane]);
    int p, end;
    lane_run(s.cr[lw * 32 + lane], p, end);
    float acc = 0.0f;
    SplitSums sp;
#pragma unroll 4
    for (; p < end; p += 32) {
      const int r = s.crow[p];
      if (split_row<MODE>(a, r))
        sp.add(__float_as_uint(s.vc[p]), vw[r]);
      else
        acc = acc + s.vc[p] * operand<MODE>(v, vw, r);
    }
    const int span = __reduce_max_sync(FULL, ln.G);
    acc = group_sum(acc, ln, span);
    if constexpr (Arith<MODE>::A_SPLIT) sp = group_sum(sp, ln, span);
    if (!ln.idle() && ln.g == 0) {
      if constexpr (Arith<MODE>::A_SPLIT) out(ln.seg, acc + sp.sum());
      else out(ln.seg, acc);
    }
  }
}

// out(r, sum_j A[r][j] v[j]) for every row r, by the row lane plan; a
// split row (`split_row`) sums its three products
template <int MODE, class Out>
__device__ __forceinline__ void row_products(const Args& a, const Smem& s,
                                             const float* v,
                                             const unsigned* vw, Out out) {
  const int lane = threadIdx.x & 31;
  for (int lw = threadIdx.x >> 5; lw < a.rwarps; lw += WARPS) {
    const Lane ln(s.rl[lw * 32 + lane]);
    int p, end;
    lane_run(s.rr[lw * 32 + lane], p, end);
    const bool split = !ln.idle() && split_row<MODE>(a, ln.seg);
    float acc = 0.0f;
    SplitSums sp;
    if (split) {
#pragma unroll 4
      for (; p < end; p += 32)
        sp.add(__float_as_uint(s.vr[p]), vw[s.rcol[p]]);
    } else {
#pragma unroll 4
      for (; p < end; p += 32)
        acc = acc + s.vr[p] * operand<MODE>(v, vw, s.rcol[p]);
    }
    const int span = __reduce_max_sync(FULL, ln.G);
    acc = group_sum(acc, ln, span);
    if constexpr (Arith<MODE>::A_SPLIT) sp = group_sum(sp, ln, span);
    if (!ln.idle() && ln.g == 0) out(ln.seg, split ? sp.sum() : acc);
  }
}

// A part's rows j of the n x n products: the p-th run of `k_run(n)`
// consecutive rows (odd, so the four parts' first rows differ mod 4 and a
// warp's loads at row stride kld(n) = 8 mod 32 fall in 32 banks)
__device__ __forceinline__ int k_run(int n) {
  return ((n + K_PARTS - 1) / K_PARTS) | 1;
}

// The sums over the j-parts of a column, added in the xor butterfly (lanes
// 8 apart, then 16): (s0 + s1) + (s2 + s3), the same bits in every part
__device__ __forceinline__ float parts_sum(float v) {
  v = v + __shfl_xor_sync(FULL, v, 8);
  return v + __shfl_xor_sync(FULL, v, 16);
}

// The columns of warp task t: this lane's k and k + 8 (of 16), and the
// rows [j0, j1) of its part
struct KTask {
  int k, part, j0, j1;
  __device__ __forceinline__ KTask(int n, int t) {
    const int lane = threadIdx.x & 31;
    part = lane / K_COLS;
    k = t * K_TASK + lane % K_COLS;
    j0 = min(part * k_run(n), n);
    j1 = min(j0 + k_run(n), n);
  }
  // column c's sum from every part, to out in part 0's lane (columns past
  // n are computed on column n - 1 and dropped)
  template <class Out>
  __device__ __forceinline__ void put(int n, int c, float sum, Out out)
      const {
    if (part == 0 && k + c * K_COLS < n) out(k + c * K_COLS, sum);
  }
};

__device__ __forceinline__ int k_tasks(int n) {
  return (n + K_TASK - 1) / K_TASK;
}

// out(k, sum_j v[j] M[j][k]) for every column k of an n x n matrix M with
// row stride ld, fp32: a warp task's 16 columns, lane part p over its run
// of j ascending.  `M` in shared memory (the K^-1 product of HIGHEST;
// UNROLL 4) or device memory (a dense P read at each check: UNROLL 8, so
// a lane has 16 loads in flight a round trip).
template <int UNROLL, class Out>
__device__ __forceinline__ void mat_products(int n, const float* v,
                                             const float* M, int ld,
                                             Out out) {
  for (int t = threadIdx.x >> 5; t < k_tasks(n); t += WARPS) {
    const KTask tk(n, t);
    const float* M0 = M + min(tk.k, n - 1);
    const float* M1 = M + min(tk.k + K_COLS, n - 1);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll UNROLL
    for (int j = tk.j0; j < tk.j1; ++j) {
      const float vj = v[j];
      a0 = a0 + vj * M0[j * ld];
      a1 = a1 + vj * M1[j * ld];
    }
    tk.put(n, 0, parts_sum(a0), out);
    tk.put(n, 1, parts_sum(a1), out);
  }
}

// xt = rhs' K^-1 in the mode's arithmetic, then out(k, xt[k])
template <int MODE, class Out>
__device__ __forceinline__ void k_products(const Args& a, const Smem& s,
                                           Out out) {
  using M = Arith<MODE>;
  const int n = a.n, ld = kld(n);
  if constexpr (M::K_SPLIT) {
    // the K^-1 words are bf16 pairs
    const unsigned* Kw = reinterpret_cast<const unsigned*>(s.K);
    for (int t = threadIdx.x >> 5; t < k_tasks(n); t += WARPS) {
      const KTask tk(n, t);
      const unsigned* K0 = Kw + min(tk.k, n - 1);
      const unsigned* K1 = Kw + min(tk.k + K_COLS, n - 1);
      SplitSums s0, s1;
#pragma unroll 4
      for (int j = tk.j0; j < tk.j1; ++j) {
        const unsigned vj = s.vn1[j];
        s0.add(K0[j * ld], vj);
        s1.add(K1[j * ld], vj);
      }
      const auto sum = [](SplitSums sp) {
        sp.hh = parts_sum(sp.hh);
        sp.hl = parts_sum(sp.hl);
        sp.lh = parts_sum(sp.lh);
        return sp.sum();
      };
      tk.put(n, 0, sum(s0), out);
      tk.put(n, 1, sum(s1), out);
    }
  } else if constexpr (M::K_ROUND) {
    // K^-1 and rhs rounded to bf16
    for (int t = threadIdx.x >> 5; t < k_tasks(n); t += WARPS) {
      const KTask tk(n, t);
      const float* K0 = s.K + min(tk.k, n - 1);
      const float* K1 = s.K + min(tk.k + K_COLS, n - 1);
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
      for (int j = tk.j0; j < tk.j1; ++j) {
        const float vj = hi_of(s.vn1[j]);
        a0 = a0 + vj * K0[j * ld];
        a1 = a1 + vj * K1[j * ld];
      }
      tk.put(n, 0, parts_sum(a0), out);
      tk.put(n, 1, parts_sum(a1), out);
    }
  } else {
    mat_products<4>(n, s.v1, s.K, ld, out);
  }
}

// One iteration; s.w holds w on entry and on exit (and, in every mode but
// HIGHEST, s.vm1 its words).
template <int MODE>
__device__ void iterate(const Args& a, const Smem& s) {
  using M = Arith<MODE>;
  col_products<MODE>(a, s, s.w, s.vm1, [&](int j, float atw) {
    const float rhs = (a.sigma * s.x[j] - s.q[j]) + atw;
    s.v1[j] = rhs;
    if constexpr (M::K_SPLIT || M::K_ROUND) s.vn1[j] = vec_word<MODE>(rhs);
  });
  __syncthreads();
  // xt = rhs' K^-1, and x's relaxation
  const float al = a.alpha, om = 1.0f - a.alpha;
  k_products<MODE>(a, s, [&](int k, float xt) {
    s.v2[k] = xt;
    if constexpr (M::VEC) s.vn2[k] = vec_word<MODE>(xt);
    s.x[k] = al * xt + om * s.x[k];
  });
  __syncthreads();
  // zt = A xt, and in the same lane the row's z, y and next w
  row_products<MODE>(a, s, s.v2, s.vn2, [&](int r, float zt) {
    const float rho = s.rho[r];
    const float zm = al * zt + om * s.z[r];
    const float zn = clip_keep_nan(zm + s.y[r] * (1.0f / rho), s.l[r],
                                   s.u[r]);
    const float yn = s.y[r] + rho * (zm - zn);
    s.y[r] = yn;
    s.z[r] = zn;
    const float w = rho * zn - yn;          // the next iteration's
    s.w[r] = w;
    if constexpr (M::VEC) s.vm1[r] = vec_word<MODE>(w);
  });
  __syncthreads();
}

// Unscaled statistics of the block's instance into s.st (warp 0); returns
// whether it has converged (uniform across the block).  A x and A'y take
// the mode's products (x's words in vn2, y's in vm2).  With a dense P,
// P_u x_u = x_bar' PuD goes to v2 (free between iterations), fp32 in every
// mode, this instance's PuD (n x n) read from device memory.
template <bool DENSE_P, int MODE>
__device__ bool calc_stats(const Args& a, const Smem& s, long long b) {
  const int n = a.n, m = a.m;
  if constexpr (Arith<MODE>::VEC) {
    for (int j = threadIdx.x; j < n; j += THREADS)
      s.vn2[j] = vec_word<MODE>(s.x[j]);
    for (int r = threadIdx.x; r < m; r += THREADS)
      s.vm2[r] = vec_word<MODE>(s.y[r]);
    __syncthreads();
  }
  row_products<MODE>(a, s, s.x, s.vn2,
                     [&](int r, float ax) { s.ax[r] = ax; });
  col_products<MODE>(a, s, s.y, s.vm2,
                     [&](int j, float aty) { s.v1[j] = aty; });
  if constexpr (DENSE_P)
    mat_products<8>(n, s.x, a.PuD + b * n * n, n,
                    [&](int k, float px) { s.v2[k] = px; });
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
  const int n = a.n, m = a.m, ld = kld(n);
  const float* Kb = a.Kinv + b * n * n;
  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int i = e / n;
    cp_async4(s.K + i * ld + (e - i * n), Kb + e);
  }
  // everything else with cp.async as well, so the block waits for device
  // memory once (at tile 1 a block alone on the card would otherwise wait
  // once per loop trip)
  const float* Vb = a.Aval + b * (a.sr + a.sc);
  for (int e = threadIdx.x; e < a.sr + a.sc; e += THREADS)
    cp_async4(s.vr + e, Vb + e);             // vc follows vr
  const int pw = plan_words(a.sr, a.sc, a.rwarps, a.cwarps);
  for (int e = threadIdx.x; e < pw; e += THREADS)
    cp_async4(s.rl + e, a.plan + e);
  for (int j = threadIdx.x; j < n; j += THREADS) {
    cp_async4(s.x + j, a.x + b * n + j);
    cp_async4(s.q + j, a.q + b * n + j);
    if constexpr (!DENSE_P) cp_async4(s.PuD + j, a.PuD + b * n + j);
    cp_async4(s.qu + j, a.qu + b * n + j);
    cp_async4(s.invDc + j, a.invDc + b * n + j);
  }
  for (int r = threadIdx.x; r < m; r += THREADS) {
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
  // the mode's forms of K^-1 and A
  if constexpr (M::K_SPLIT || M::K_ROUND) {
    for (int e = threadIdx.x; e < n * n; e += THREADS) {
      float* k = s.K + (e / n) * ld + e % n;
      *k = M::K_SPLIT ? __uint_as_float(split_word(*k)) : bf16_round(*k);
    }
  }
  if constexpr (M::VEC) {
    // a row slot's row is its lane's segment; a column slot's its index
    // (the pads' forms are never read)
    for (int e = threadIdx.x; e < 32 * a.rwarps; e += THREADS) {
      const Lane ln(s.rl[e]);
      int p, end;
      lane_run(s.rr[e], p, end);
      for (; p < end; p += 32) {
        if (split_row<MODE>(a, ln.seg))
          s.vr[p] = __uint_as_float(split_word(s.vr[p]));
        else if (MODE == BF16)
          s.vr[p] = bf16_round(s.vr[p]);
      }
    }
    for (int p = threadIdx.x; p < a.sc; p += THREADS) {
      if (split_row<MODE>(a, s.crow[p]))
        s.vc[p] = __uint_as_float(split_word(s.vc[p]));
      else if (MODE == BF16)
        s.vc[p] = bf16_round(s.vc[p]);
    }
  }
  for (int r = threadIdx.x; r < m; r += THREADS) {
    const float w = s.rho[r] * s.z[r] - s.y[r];
    s.w[r] = w;
    if constexpr (M::VEC) s.vm1[r] = vec_word<MODE>(w);
  }
  __syncthreads();
}

// DENSE_P: P is the dense (n x n) PuD; false, the diagonal build.  MODE:
// the precision mode (`Mode`)
template <bool DENSE_P, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
admm_wide_kernel(Args a) {
  extern __shared__ float4 sh4[];
  const Smem s = carve(reinterpret_cast<float*>(sh4), a, Arith<MODE>::VEC);
  const long long b = blockIdx.x;
  const bool active = b < a.B;               // uniform across the block
  if (active) load<DENSE_P, MODE>(a, s, b);
  const int executed = run_checks(
      a, s.flags, active, [&](bool) { iterate<MODE>(a, s); },
      [&] { return calc_stats<DENSE_P, MODE>(a, s, b); }, a.tile);
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

template <bool DENSE_P>
KernelFn of_mode(int mode) {
  switch (mode) {
    case HIGHEST: return admm_wide_kernel<DENSE_P, HIGHEST>;
    case MIXED: return admm_wide_kernel<DENSE_P, MIXED>;
    case MIXEDK6: return admm_wide_kernel<DENSE_P, MIXEDK6>;
    case HIGH: return admm_wide_kernel<DENSE_P, HIGH>;
    case BF16: return admm_wide_kernel<DENSE_P, BF16>;
  }
  return nullptr;
}

// the build's traits (csrc/admm_compact.cuh's `prepare`)
struct Wide {
  static constexpr int BLOCK = THREADS;
  static constexpr int PAIRS = 1;
  static constexpr int N_MAX = LANE_IDLE - 1;
  static size_t smem(int n, int m, int sr, int sc, int rwarps, int cwarps,
                     int mode) {
    return smem_bytes(n, m, sr, sc, rwarps, cwarps, mode != HIGHEST);
  }
  static KernelFn kernel(int dense_P, int mode) {
    return dense_P ? of_mode<true>(mode) : of_mode<false>(mode);
  }
};

}  // namespace

// x, z and y are updated in place (the wrapper passes fresh copies).
// PuD is (B, n), or (B, n, n) when dense_P is 1.  mode: `Mode`; m_eq the
// leading equality rows of the mixed modes (0 for the others).
extern "C" int admm_wide_f32(
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
  return launch<Wide>(a, mode, stream);
}

// How many clusters of `tile` blocks of this kernel the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int admm_wide_max_clusters(int n, int m, int sr, int sc,
                                      int rwarps, int cwarps, int tile,
                                      int dense_P, int mode, int* out) {
  return max_clusters<Wide>(n, m, sr, sc, rwarps, cwarps, tile, dense_P,
                            mode, out);
}

// The registers a thread of the build for `mode` and `dense_P` uses
// (cudaFuncGetAttributes), into *out.
extern "C" int admm_wide_registers(int mode, int dense_P, int* out) {
  return registers<Wide>(mode, dense_P, out);
}
