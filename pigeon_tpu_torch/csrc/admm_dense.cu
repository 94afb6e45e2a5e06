// OSQP ADMM iterations of the sparse MPC QP with a dense explicit K^-1
// ("highest" precision, diagonal P), one thread block per tile of `tile`
// consecutive instances.
//
// Replaces the TPU kernel pigeon_tpu/solver/pallas_admm.py:_kernel in its
// "highest" mode.  Per iteration (instance-local, scaled problem):
//   w  = rho z - y,  rhs = sigma x - q + A'w,  xt = rhs' K^-1,  zt = A xt
//   x <- alpha xt + (1 - alpha) x
//   zm = alpha zt + (1 - alpha) z,  z <- clip(zm + y (1/rho), l, u)
//   y <- y + rho (zm - z)
// Every `check` iterations (0 < check < n_iters) each instance computes
// its unscaled statistics (r_prim, r_dual, max|Ax|, max|z|, max|Px|,
// max|A'y|) with A x and A'y against the scaled matrix and the scalings
// (1/E, P_u D, q_u, 1/(D c)), and the block stops once every instance of
// the tile has converged (__syncthreads_and; instances past B count as
// converged, as the TPU kernel's zero-padded instances do).  The tile is
// semantics, not tiling: it is the TPU kernel's grid step, whose early
// exit takes all instances of the step.  The last check block runs only
// the remainder of n_iters, so the executed count (stats column 6) is
// exact.  check == 0 (or >= n_iters) runs a fixed n_iters.
//
// Layout: K^-1 (B, n, n), A (B, m, n), vectors (B, n) and (B, m), stats
// (B, 8), all instance-major; n <= 256 and m <= 512 at run time.  The
// tile's vectors live in shared memory; K^-1 and A (0.6 MB per instance
// at n = 193, m = 290) stream from global memory on every iteration: A'w
// with one thread per column (coalesced along a row), xt with one thread
// per column of K^-1 (K^-1 is read by rows, as rhs' K^-1), A xt with one
// warp per row.  No transposed copy of A is needed.
//
// Bound on the card: each iteration reads A twice and K^-1 once, 0.6 MB
// per instance; at B=2048 A and K^-1 (0.77 GB) do not fit the 50 MB L2, so
// an iteration of the whole batch is bound by device memory at ~0.37 ms.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_MAX = WARPS;     // one warp per instance in the stats
constexpr int NMAX = 256, MMAX = 512;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* __restrict__ Kinv;   // (B, n, n)
  const float* __restrict__ A;      // (B, m, n)
  const float* __restrict__ q;      // (B, n)
  const float* __restrict__ l;      // (B, m)
  const float* __restrict__ u;      // (B, m)
  const float* __restrict__ rho;    // (B, m)
  float* __restrict__ x;            // (B, n) in/out
  float* __restrict__ z;            // (B, m) in/out
  float* __restrict__ y;            // (B, m) in/out
  const float* __restrict__ E;      // (B, m)
  const float* __restrict__ PuD;    // (B, n)
  const float* __restrict__ qu;     // (B, n)
  const float* __restrict__ invDc;  // (B, n)
  float* __restrict__ stats;        // (B, 8)
  int B, n, m, tile, n_iters, check;
  float sigma, alpha, eps_abs, eps_rel;
};

__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// clip(v, lo, hi) that keeps a NaN v, as jnp.clip and torch do
__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}

// Shared vectors of the tile: instance i's slices at i * n or i * m.
struct Tile {
  float* x;     // (tile, n)
  float* v1;    // (tile, n)  rhs, then A'y in the statistics
  float* v2;    // (tile, n)  xt
  float* z;     // (tile, m)
  float* y;     // (tile, m)
  float* w;     // (tile, m)  rho z - y, then A xt, then A x
};

// out[i][j] = sum_r A_i[r][j] v[i][r]: thread per (instance, column)
__device__ __forceinline__ void mat_t_vec(const Args& a, long long b0, int cnt,
                                          const float* v, float* out) {
  const int n = a.n, m = a.m;
  for (int e = threadIdx.x; e < cnt * n; e += THREADS) {
    const int i = e / n, j = e - i * n;
    const float* Ai = a.A + (b0 + i) * (long long)m * n + j;
    const float* vi = v + i * m;
    float acc = 0.0f;
#pragma unroll 8
    for (int r = 0; r < m; ++r) acc = acc + Ai[(long long)r * n] * vi[r];
    out[i * n + j] = acc;
  }
}

// out[i][r] = sum_j A_i[r][j] v[i][j]: warp per (instance, row)
__device__ __forceinline__ void mat_vec(const Args& a, long long b0, int cnt,
                                        const float* v, float* out) {
  const int n = a.n, m = a.m;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < cnt * m; e += WARPS) {
    const int i = e / m, r = e - i * m;
    const float* Ar = a.A + ((b0 + i) * (long long)m + r) * n;
    const float* vi = v + i * n;
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) acc = acc + Ar[j] * vi[j];
    acc = warp_sum(acc);
    if (lane == 0) out[i * m + r] = acc;
  }
}

__device__ void iterate(const Args& a, long long b0, int cnt, const Tile& s) {
  const int n = a.n, m = a.m;
  for (int e = threadIdx.x; e < cnt * m; e += THREADS) {
    const long long o = b0 * m + e;
    s.w[e] = a.rho[o] * s.z[e] - s.y[e];
  }
  __syncthreads();
  mat_t_vec(a, b0, cnt, s.w, s.v1);
  __syncthreads();
  for (int e = threadIdx.x; e < cnt * n; e += THREADS)
    s.v1[e] = (a.sigma * s.x[e] - a.q[b0 * n + e]) + s.v1[e];
  __syncthreads();
  // xt = rhs' K^-1: thread per (instance, column k), rows of K^-1 streamed
  for (int e = threadIdx.x; e < cnt * n; e += THREADS) {
    const int i = e / n, k = e - i * n;
    const float* Ki = a.Kinv + (b0 + i) * (long long)n * n + k;
    const float* rhs = s.v1 + i * n;
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) acc = acc + rhs[j] * Ki[(long long)j * n];
    s.v2[e] = acc;
  }
  __syncthreads();
  mat_vec(a, b0, cnt, s.v2, s.w);
  __syncthreads();
  const float al = a.alpha, om = 1.0f - a.alpha;
  for (int e = threadIdx.x; e < cnt * n; e += THREADS)
    s.x[e] = al * s.v2[e] + om * s.x[e];
  for (int e = threadIdx.x; e < cnt * m; e += THREADS) {
    const long long o = b0 * m + e;
    const float rho = a.rho[o];
    const float zm = al * s.w[e] + om * s.z[e];
    const float zn = clip_keep_nan(zm + s.y[e] * (1.0f / rho), a.l[o], a.u[o]);
    s.y[e] = s.y[e] + rho * (zm - zn);
    s.z[e] = zn;
  }
  __syncthreads();
}

// Unscaled statistics of instance `warp` of the tile into st (tile, 8);
// returns whether every instance of the tile has converged.
__device__ bool calc_stats(const Args& a, long long b0, int cnt,
                           const Tile& s, float* st) {
  const int n = a.n, m = a.m;
  mat_vec(a, b0, cnt, s.x, s.w);        // A x
  mat_t_vec(a, b0, cnt, s.y, s.v1);     // A'y
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bool conv = true;
  if (warp < cnt) {
    const int i = warp;
    const long long bm = (b0 + i) * m, bn = (b0 + i) * n;
    float s0 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int r = lane; r < m; r += 32) {
      const float invE = 1.0f / a.E[bm + r];
      const float Ax_u = s.w[i * m + r] * invE;
      const float z_u = s.z[i * m + r] * invE;
      s0 = nmax(s0, fabsf(Ax_u - z_u));
      s2 = nmax(s2, fabsf(Ax_u));
      s3 = nmax(s3, fabsf(z_u));
    }
    float s1 = 0.0f, s4 = 0.0f, s5 = 0.0f, aqu = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float Px_u = a.PuD[bn + j] * s.x[i * n + j];
      const float qu = a.qu[bn + j];
      const float Aty_u = s.v1[i * n + j] * a.invDc[bn + j];
      s1 = nmax(s1, fabsf(Px_u + qu + Aty_u));
      s4 = nmax(s4, fabsf(Px_u));
      s5 = nmax(s5, fabsf(Aty_u));
      aqu = nmax(aqu, fabsf(qu));
    }
    s0 = warp_max(s0); s1 = warp_max(s1); s2 = warp_max(s2);
    s3 = warp_max(s3); s4 = warp_max(s4); s5 = warp_max(s5);
    aqu = warp_max(aqu);
    if (lane == 0) {
      float* si = st + i * 8;
      si[0] = s0; si[1] = s1; si[2] = s2; si[3] = s3; si[4] = s4; si[5] = s5;
      si[6] = 0.0f; si[7] = 0.0f;
    }
    const float eps_p = a.eps_abs + a.eps_rel * nmax(s2, s3);
    const float eps_d = a.eps_abs + a.eps_rel * nmax(nmax(s4, s5), aqu);
    conv = (s0 <= eps_p) && (s1 <= eps_d);
  }
  return __syncthreads_and(conv) != 0;
}

__global__ void __launch_bounds__(THREADS)
admm_dense_kernel(Args a) {
  extern __shared__ float sh[];
  const int n = a.n, m = a.m;
  const long long b0 = (long long)blockIdx.x * a.tile;
  const int cnt = (int)min((long long)a.tile, (long long)a.B - b0);
  Tile s;
  s.x = sh;
  s.v1 = s.x + a.tile * n;
  s.v2 = s.v1 + a.tile * n;
  s.z = s.v2 + a.tile * n;
  s.y = s.z + a.tile * m;
  s.w = s.y + a.tile * m;
  float* st = s.w + a.tile * m;         // (tile, 8)

  for (int e = threadIdx.x; e < cnt * n; e += THREADS) s.x[e] = a.x[b0 * n + e];
  for (int e = threadIdx.x; e < cnt * m; e += THREADS) {
    s.z[e] = a.z[b0 * m + e];
    s.y[e] = a.y[b0 * m + e];
  }
  __syncthreads();

  int executed;
  if (0 < a.check && a.check < a.n_iters) {
    const int n_blocks = (a.n_iters + a.check - 1) / a.check;
    int it = 0;
    bool done = false;
    while (!done && it < n_blocks) {       // uniform across the block
      const int k_len = min(a.check, a.n_iters - it * a.check);
      for (int t = 0; t < k_len; ++t) iterate(a, b0, cnt, s);
      done = calc_stats(a, b0, cnt, s, st);
      ++it;
    }
    executed = min(it * a.check, a.n_iters);
  } else {
    for (int t = 0; t < a.n_iters; ++t) iterate(a, b0, cnt, s);
    calc_stats(a, b0, cnt, s, st);
    executed = a.n_iters;
  }
  if (threadIdx.x < cnt) st[threadIdx.x * 8 + 6] = (float)executed;
  __syncthreads();
  for (int e = threadIdx.x; e < cnt * n; e += THREADS) a.x[b0 * n + e] = s.x[e];
  for (int e = threadIdx.x; e < cnt * m; e += THREADS) {
    a.z[b0 * m + e] = s.z[e];
    a.y[b0 * m + e] = s.y[e];
  }
  for (int e = threadIdx.x; e < cnt * 8; e += THREADS)
    a.stats[b0 * 8 + e] = st[e];
}

}  // namespace

// x, z and y are updated in place (the wrapper passes fresh copies).
extern "C" int admm_dense_f32(
    const float* Kinv, const float* A, const float* q, const float* l,
    const float* u, const float* rho, float* x, float* z, float* y,
    const float* E, const float* PuD, const float* qu, const float* invDc,
    float* stats, int B, int n, int m, int tile, int n_iters, float sigma,
    float alpha, int check, float eps_abs, float eps_rel, void* stream) {
  if (n < 1 || n > NMAX || m < 1 || m > MMAX || tile < 1 || tile > TILE_MAX
      || n_iters < 0 || check < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{Kinv, A, q, l, u, rho, x, z, y, E, PuD, qu, invDc, stats,
         B, n, m, tile, n_iters, check, sigma, alpha, eps_abs, eps_rel};
  const size_t shmem = (size_t)tile * (3 * n + 3 * m + 8) * sizeof(float);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + tile - 1) / tile;
  admm_dense_kernel<<<blocks, THREADS, shmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
