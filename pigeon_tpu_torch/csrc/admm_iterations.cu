// OSQP ADMM iterations of the soft condensed MPC QP: one warp per
// instance, its K^-1 and A resident in shared memory for the whole call,
// 8 instances per block, and the 128-instance exit group one cluster of
// 16 blocks.
//
// Replaces the TPU kernel pigeon_tpu/solver/lane_admm.py:_iter_kernel.
// Per iteration (instance-local):
//   rhs = sigma x - q + A'(rho z - y),  xt = K^-1 rhs,  zt = A xt
//   x  <- alpha xt + (1 - alpha) x
//   zm  = alpha zt + (1 - alpha) z,  v = zm + y / rho
//   z  <- v - clip(v - u, 0, cap) - clip(v - l, -cap, 0)
//          (shrink prox of the exact penalty W dist(., [l, u]), cap = W/rho;
//           an infinite cap is the hard box projection)
//   y  <- y + rho (zm - z)
// Every `check` iterations (0 < check < n_iters) each instance writes 8
// unscaled statistics (r_prim, r_dual, max|Ax|, max|z|, max|Px|, max|A'y|,
// executed iterations, 0) and its group stops once every instance of the
// group has converged (instances past B count as converged).  The group
// is part of the semantics: a converged instance keeps iterating until
// its whole group has converged, exactly as the TPU kernel's 128-lane
// block does.  check == 0 (or >= n_iters) runs a fixed n_iters.
//
// Layout at the boundary: instances are the fastest-moving index --
// matrices (rows, cols, B), vectors (len, B) -- as the pipeline keeps them;
// the 8 instances of a block are 32 contiguous bytes of every entry, so
// the one load per call is sector-efficient.
//
// Residency.  Each warp's instance keeps K^-1 (n x n) and A (m rows of
// n | 1 words: an odd row stride, so a warp reading one column of 32 rows
// hits 32 banks) in the block's shared memory for the call, copied in
// once with cp.async, beside two vectors a warp: 8 x 19.6 KB at (n, m) =
// (30, 124), 8 x 26.8 KB at (30, 180) (`plan_smem` in
// solver/lane_admm.py mirrors `smem_bytes`; larger shapes are refused).
// z, y, rho, l, u, cap and E sit in registers, row r on lane r % 32 (RPL
// = ceil(m / 32) rows a lane); x, q and the n-vectors one entry a lane.
// Every sum keeps the first (thread-per-instance) design's order; the
// vector a sum runs over is put in the warp's shared vector and read four
// entries at a time (a shuffle per entry would double the shared-memory
// pipe's work, which bounds the kernel):
//   A'w    lane j, rows ascending;
//   xt     lane k, j ascending, K^-1 row j from shared memory
//          (consecutive lanes, consecutive words);
//   A xt   lane r % 32 for its rows, j ascending;
//   P x    (statistics) lane k, j ascending, P read from device memory
//          once per check.
//
// The exit group of 128 consecutive instances is a cluster of 16 blocks
// (above the portable 8: cudaFuncAttributeNonPortableClusterSizeAllowed),
// launched with cudaLaunchKernelEx; the grid is padded to whole groups.
// At each check every block writes whether all its instances converged
// into its shared memory, one barrier.cluster, and every warp reads the
// 16 flags through distributed shared memory; the flags are
// double-buffered by check index, so one cluster barrier per check is
// enough.
//
// Bound on the card (H100 SXM): the call must read K^-1 and A once (33
// MB at B = 8192, m = 124: ~0.01 ms of device memory) and do per iteration
// 2 n^2 + 4 nnz(A) operations.  The first design (a thread per instance,
// K^-1 and A streamed through device memory every iteration, 64 blocks of
// 4 warps at B = 8192) read 39.18 ms at m = 124 (62.2 mean iterations) and
// 136.21 ms at m = 180 (156.4), load latency bound (PERF.md).  Here
// each iteration reads A twice and K^-1 once from shared memory (2 m + n
// wavefronts a warp), and that pipe, shared with the shuffles, bounds
// the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NMAX = 32;       // n <= NMAX: one entry of x a lane
constexpr int IPB = 8;         // instances (warps) per block
constexpr int THREADS = 32 * IPB;
constexpr int GROUP = 128;     // instances per exit group
constexpr int CLUSTER = GROUP / IPB;
constexpr int RPL_MAX = 6;     // rows a lane: m <= 32 RPL_MAX
constexpr int SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

// NT > 0: n == NT is known at compile time (the main path's n = 30, the
// horizon N_short=5, N_long=10), so the guards fold away; NT == 0: any
// n <= NMAX at run time, for the soft QP of any other horizon
// (n = 2 (N_short + N_long)).
template <int NT>
struct Dim {
  __device__ static int n(int runtime_n) { return NT > 0 ? NT : runtime_n; }
};

struct Args {
  const float* __restrict__ Kinv;   // (n, n, B)
  const float* __restrict__ A;      // (m, n, B)
  const float* __restrict__ q;      // (n, B)
  const float* __restrict__ l;      // (m, B)
  const float* __restrict__ u;      // (m, B)
  const float* __restrict__ rho;    // (m, B)
  const float* __restrict__ cap;    // (m, B)
  float* __restrict__ x;            // (n, B) in/out
  float* __restrict__ z;            // (m, B) in/out
  float* __restrict__ y;            // (m, B) in/out
  const float* __restrict__ E;      // (m, B)
  const float* __restrict__ PuD;    // (n, n, B)
  const float* __restrict__ qu;     // (n, B)
  const float* __restrict__ invDc;  // (n, B)
  float* __restrict__ stats;        // (8, B)
  int B, n, m;
  float sigma, alpha, eps_abs, eps_rel;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared memory of a block: 4 words of flags; per instance (warp) a vector
// of m (rounded up to 4) and one of 32 floats, 16-byte aligned for float4
// reads; then per instance K^-1 (n n) and A (m (n | 1)).
__host__ __device__ inline size_t smem_bytes(int n, int m) {
  return 4 * (4 + (size_t)IPB * (round4(m) + 32)
              + (size_t)IPB * ((size_t)n * n + (size_t)m * (n | 1)));
}

// One instance's state in its warp's registers and shared memory.
template <int NT, int RPL>
struct Inst {
  const float* K;     // n x n, row j at j n
  const float* As;    // m x AS
  float* vm;          // an m-vector (w or y) broadcast to the warp
  float* vn;          // an n-vector (rhs, xt or x) broadcast to the warp
  int AS;
  int aoff[RPL];      // offset of this lane's row k (clamped to m - 1)
  float x, q, qu, invDc;
  float z[RPL], y[RPL], rho[RPL], lo[RPL], hi[RPL], cap[RPL], E[RPL];
};

// max and min that keep a NaN of either argument, one instruction each
// (max.NaN, min.NaN), as the plain version's clamp and amax do: an
// instance whose QP holds a NaN gets NaN statistics and never converges
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float nmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// sum_r A[r][jc] v_r over r ascending; v_r on lane r % 32 slot r / 32,
// put in shared memory and read back four at a time
template <int NT, int RPL>
__device__ __forceinline__ float col_sum(const Inst<NT, RPL>& s, int m,
                                         int lane, int jc,
                                         const float (&v)[RPL]) {
  __syncwarp();                               // earlier readers are done
#pragma unroll
  for (int k = 0; k < RPL; ++k)
    if (32 * k + lane < m) s.vm[32 * k + lane] = v[k];
  __syncwarp();
  const float4* v4 = reinterpret_cast<const float4*>(s.vm);
  const float* Aj = s.As + jc;
  const int AS = s.AS;
  float acc = 0.0f;
  int r = 0;
#pragma unroll 2
  for (; r + 4 <= m; r += 4) {
    const float4 w = v4[r >> 2];
    acc = acc + Aj[r * AS] * w.x;
    acc = acc + Aj[(r + 1) * AS] * w.y;
    acc = acc + Aj[(r + 2) * AS] * w.z;
    acc = acc + Aj[(r + 3) * AS] * w.w;
  }
  for (; r < m; ++r) acc = acc + Aj[r * AS] * s.vm[r];
  return acc;
}

// puts lane j's v (j < n) in the warp's shared n-vector
template <int NT, int RPL>
__device__ __forceinline__ void share_n(const Inst<NT, RPL>& s, int lane,
                                        float v) {
  __syncwarp();
  s.vn[lane] = v;
  __syncwarp();
}

// out[k] = sum_j A[row k][j] vn_j over j ascending
template <int NT, int RPL>
__device__ __forceinline__ void row_sums(const Inst<NT, RPL>& s, int n,
                                         float (&out)[RPL]) {
  const float4* v4 = reinterpret_cast<const float4*>(s.vn);
#pragma unroll
  for (int k = 0; k < RPL; ++k) out[k] = 0.0f;
  int j = 0;
#pragma unroll 2
  for (; j + 4 <= n; j += 4) {
    const float4 v = v4[j >> 2];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const float* Ar = s.As + s.aoff[k] + j;
      out[k] = out[k] + Ar[0] * v.x;
      out[k] = out[k] + Ar[1] * v.y;
      out[k] = out[k] + Ar[2] * v.z;
      out[k] = out[k] + Ar[3] * v.w;
    }
  }
  for (; j < n; ++j) {
    const float vj = s.vn[j];
#pragma unroll
    for (int k = 0; k < RPL; ++k) out[k] = out[k] + s.As[s.aoff[k] + j] * vj;
  }
}

template <int NT, int RPL>
__device__ __forceinline__ void iterate(const Args& a, Inst<NT, RPL>& s,
                                        int lane, int jc) {
  const int n = Dim<NT>::n(a.n), m = a.m;
  float w[RPL];
#pragma unroll
  for (int k = 0; k < RPL; ++k) w[k] = s.rho[k] * s.z[k] - s.y[k];
  const float atw = col_sum(s, m, lane, jc, w);
  share_n(s, lane, (a.sigma * s.x - s.q) + atw);      // rhs
  const float4* r4 = reinterpret_cast<const float4*>(s.vn);
  const float* Kk = s.K + jc;
  float xt = 0.0f;
  int j = 0;
#pragma unroll
  for (; j + 4 <= n; j += 4) {
    const float4 rj = r4[j >> 2];
    xt = xt + rj.x * Kk[j * n];
    xt = xt + rj.y * Kk[(j + 1) * n];
    xt = xt + rj.z * Kk[(j + 2) * n];
    xt = xt + rj.w * Kk[(j + 3) * n];
  }
  for (; j < n; ++j) xt = xt + s.vn[j] * Kk[j * n];
  share_n(s, lane, xt);
  float zt[RPL];
  row_sums(s, n, zt);
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    if (32 * k + lane < m) {
      const float rho = s.rho[k], z = s.z[k], y = s.y[k], cap = s.cap[k];
      const float zm = a.alpha * zt[k] + (1.0f - a.alpha) * z;
      const float v = zm + y * (1.0f / rho);
      const float zn = v - nmin(nmax(v - s.hi[k], 0.0f), cap)
                       - nmin(nmax(v - s.lo[k], -cap), 0.0f);
      s.z[k] = zn;
      s.y[k] = y + rho * (zm - zn);
    }
  }
  s.x = a.alpha * xt + (1.0f - a.alpha) * s.x;
}

// Unscaled residual statistics into st (every lane); returns the
// instance's convergence (uniform across the warp).
template <int NT, int RPL>
__device__ __forceinline__ bool calc_stats(const Args& a,
                                           const Inst<NT, RPL>& s, int lane,
                                           int jc, long long b,
                                           float (&st)[8]) {
  const int B = a.B, n = Dim<NT>::n(a.n), m = a.m;
  share_n(s, lane, s.x);
  float ax[RPL];
  row_sums(s, n, ax);
  const float aty = col_sum(s, m, lane, jc, s.y);
  float s0 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    if (32 * k + lane < m) {
      const float invE = 1.0f / s.E[k];
      const float Ax_u = ax[k] * invE, z_u = s.z[k] * invE;
      s0 = nmax(s0, fabsf(Ax_u - z_u));
      s2 = nmax(s2, fabsf(Ax_u));
      s3 = nmax(s3, fabsf(z_u));
    }
  }
  float px = 0.0f;
#pragma unroll 6
  for (int j = 0; j < n; ++j)
    px = px + s.vn[j] * a.PuD[((long long)j * n + jc) * B + b];
  float s1 = 0.0f, s4 = 0.0f, s5 = 0.0f, aqu = 0.0f;
  if (lane < n) {
    const float Aty_u = aty * s.invDc;
    s1 = fabsf(px + s.qu + Aty_u);
    s4 = fabsf(px);
    s5 = fabsf(Aty_u);
    aqu = fabsf(s.qu);
  }
  s0 = warp_max(s0); s1 = warp_max(s1); s2 = warp_max(s2);
  s3 = warp_max(s3); s4 = warp_max(s4); s5 = warp_max(s5);
  aqu = warp_max(aqu);
  st[0] = s0; st[1] = s1; st[2] = s2; st[3] = s3;
  st[4] = s4; st[5] = s5; st[6] = 0.0f; st[7] = 0.0f;
  const float eps_p = a.eps_abs + a.eps_rel * nmax(s2, s3);
  const float eps_d = a.eps_abs + a.eps_rel * nmax(nmax(s4, s5), aqu);
  return (s0 <= eps_p) && (s1 <= eps_d);
}

template <int NT, int RPL>
__global__ void __launch_bounds__(THREADS, 1)
admm_kernel(Args a, int n_iters, int check) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  int* flags = reinterpret_cast<int*>(sh);
  const int n = Dim<NT>::n(a.n), m = a.m, B = a.B;
  const int AS = n | 1, per = n * n + m * AS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b0 = (long long)blockIdx.x * IPB;
  const long long b = b0 + warp;
  const bool active = b < B;
  float* vecs = sh + 4;
  float* mats = vecs + IPB * (round4(m) + 32);

  // the block's 8 instances' K^-1 and A, once, with cp.async: 8
  // consecutive threads copy one entry of the 8 instances (32 contiguous
  // bytes); the pad column of A (j = n when n is even) is never read
  {
    const int i = threadIdx.x % IPB, g = threadIdx.x / IPB;
    constexpr int G = THREADS / IPB;
    const long long bi = b0 + i;
    if (bi < B) {
      float* Ki = mats + i * per;
      float* Ai = Ki + n * n;
      for (int jk = g; jk < n * n; jk += G)
        cp_async4(Ki + jk, a.Kinv + (long long)jk * B + bi);
      for (int r = 0; r < m; ++r)
        for (int j = g; j < n; j += G)
          cp_async4(Ai + r * AS + j, a.A + ((long long)r * n + j) * B + bi);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  Inst<NT, RPL> s;
  s.K = mats + warp * per;
  s.As = s.K + n * n;
  s.vm = vecs + warp * round4(m);
  s.vn = vecs + IPB * round4(m) + warp * 32;
  s.AS = AS;
  const int jc = lane < n ? lane : 0;
#pragma unroll
  for (int k = 0; k < RPL; ++k) s.aoff[k] = min(32 * k + lane, m - 1) * AS;
  const bool mine = active && lane < n;
  s.x = mine ? a.x[(long long)lane * B + b] : 0.0f;
  s.q = mine ? a.q[(long long)lane * B + b] : 0.0f;
  s.qu = mine ? a.qu[(long long)lane * B + b] : 0.0f;
  s.invDc = mine ? a.invDc[(long long)lane * B + b] : 0.0f;
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = 32 * k + lane;
    const bool row = active && r < m;
    const long long o = (long long)r * B + b;
    s.z[k] = row ? a.z[o] : 0.0f;
    s.y[k] = row ? a.y[o] : 0.0f;
    s.rho[k] = row ? a.rho[o] : 1.0f;
    s.lo[k] = row ? a.l[o] : 0.0f;
    s.hi[k] = row ? a.u[o] : 0.0f;
    s.cap[k] = row ? a.cap[o] : 0.0f;
    s.E[k] = row ? a.E[o] : 1.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  float st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = 0.0f;
  int executed;
  if (0 < check && check < n_iters) {
    cg::cluster_group cluster = cg::this_cluster();
    const int n_blocks = (n_iters + check - 1) / check;
    int it = 0;
    bool done = false;
    while (!done && it < n_blocks) {       // uniform across the group
      const int k_len = min(check, n_iters - it * check);
      bool conv = true;                    // instances past B
      if (active) {
        for (int t = 0; t < k_len; ++t) iterate(a, s, lane, jc);
        conv = calc_stats(a, s, lane, jc, b, st);
      }
      const int all_mine = __syncthreads_and(conv);
      if (threadIdx.x == 0) flags[it & 1] = all_mine;
      cluster.sync();
      int all = 1;
      if (lane < (int)cluster.num_blocks())
        all = *cluster.map_shared_rank(flags + (it & 1), lane);
      done = __all_sync(FULL, all) != 0;
      ++it;
    }
    executed = min(it * check, n_iters);
    // no block leaves while another may still read its flags
    cluster.sync();
  } else {
    if (active) {
      for (int t = 0; t < n_iters; ++t) iterate(a, s, lane, jc);
      calc_stats(a, s, lane, jc, b, st);
    }
    executed = n_iters;
  }
  if (!active) return;
  if (lane < n) a.x[(long long)lane * B + b] = s.x;
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = 32 * k + lane;
    if (r < m) {
      a.z[(long long)r * B + b] = s.z[k];
      a.y[(long long)r * B + b] = s.y[k];
    }
  }
  st[6] = (float)executed;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (lane == i) a.stats[(long long)i * B + b] = st[i];
}

cudaLaunchConfig_t launch_config(int B, size_t shmem,
                                 cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((B + GROUP - 1) / GROUP) * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

using KernelFn = void (*)(Args, int, int);

// The build for (n, m), with its attributes set; nullptr if none fits.
KernelFn pick(int n, int m, size_t* shmem, cudaError_t* err) {
  *err = cudaSuccess;
  *shmem = smem_bytes(n, m);
  if (n < 1 || n > NMAX || m < 1 || m > 32 * RPL_MAX
      || *shmem > (size_t)SMEM_MAX) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  KernelFn fn = &admm_kernel<0, 6>;
  if (n == 30) fn = m <= 128 ? &admm_kernel<30, 4> : &admm_kernel<30, 6>;
  *err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*shmem);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return *err == cudaSuccess ? fn : nullptr;
}

}  // namespace

// x, z and y are updated in place (the wrapper passes fresh copies).
extern "C" int admm_iterations_f32(
    const float* Kinv, const float* A, const float* q, const float* l,
    const float* u, const float* rho, const float* cap, float* x, float* z,
    float* y, const float* E, const float* PuD, const float* qu,
    const float* invDc, float* stats, int B, int n, int m, int n_iters,
    float sigma, float alpha, int check, float eps_abs, float eps_rel,
    void* stream) {
  size_t shmem = 0;
  cudaError_t err;
  const KernelFn fn = pick(n, m, &shmem, &err);
  if (fn == nullptr) return (int)err;
  if (n_iters < 0 || check < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{Kinv, A, q, l, u, rho, cap, x, z, y, E, PuD, qu, invDc, stats,
         B, n, m, sigma, alpha, eps_abs, eps_rel};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, shmem, attr, stream);
  err = cudaLaunchKernelEx(&cfg, fn, a, n_iters, check);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many 16-block clusters (exit groups) of the (n, m) build the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int admm_iterations_max_clusters(int n, int m, int* out) {
  size_t shmem = 0;
  cudaError_t err;
  const KernelFn fn = pick(n, m, &shmem, &err);
  if (fn == nullptr) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(GROUP, shmem, attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}
