// OSQP ADMM iterations of the soft condensed MPC QP, one thread per
// instance, one 128-thread block per group of 128 consecutive instances.
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
// Every `check` iterations (0 < check < n_iters) the thread writes 8
// unscaled statistics (r_prim, r_dual, max|Ax|, max|z|, max|Px|, max|A'y|,
// executed iterations, 0) and the block stops once every instance of its
// group has converged (__syncthreads_and; instances past B count as
// converged).  The group is part of the semantics: a converged instance
// keeps iterating until its whole group has converged, exactly as the
// TPU kernel's 128-lane block does.  check == 0 (or >= n_iters) runs a
// fixed n_iters.
//
// Layout: instances are the fastest-moving index -- matrices (rows, cols,
// B), vectors (len, B) -- so every load and store coalesces, and A is read
// both ways without a transposed copy.  x lives in registers; z and y
// (124 values each at m = 124) stream through device memory.
//
// Bound on the card: per iteration each instance reads A twice and K^-1
// once (~33 KB), ~274 MB per iteration at B=8192; A alone (122 MB) does not
// fit the 50 MB L2, so at full occupancy this design would be bound by
// device memory bandwidth.  It is not at full occupancy: one thread per
// instance and one block per group give 64 blocks of 4 warps at B=8192,
// half of the 132 SMs, so the dependent loads' latency sets its time
// (PERF.md has the measured rate).  Splitting an instance's rows over
// several threads of its group is the next design.

#include <cuda_runtime.h>

namespace {

constexpr int NMAX = 32;     // n <= NMAX, held in registers
constexpr int GROUP = 128;   // instances per block (the exit group)

// NT > 0: n == NT is known at compile time (the main path's n = 30, the
// horizon N_short=5, N_long=10), so the guards fold away and the vectors
// stay in registers; NT == 0: any n <= NMAX at run time, for the soft QP
// of any other horizon (n = 2 (N_short + N_long)).
template <int NT>
struct Dim {
  static constexpr int cap = NT > 0 ? NT : NMAX;
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

template <int NT>
__device__ __forceinline__ void iterate(const Args& a, int b,
                                        float (&x)[Dim<NT>::cap],
                                        const float (&q)[Dim<NT>::cap]) {
  constexpr int NMAX = Dim<NT>::cap;
  const int B = a.B, n = Dim<NT>::n(a.n), m = a.m;
  float atw[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) atw[j] = 0.0f;
  for (int r = 0; r < m; ++r) {
    const float w = a.rho[r * B + b] * a.z[r * B + b] - a.y[r * B + b];
    const float* Ar = a.A + (long long)r * n * B + b;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) atw[j] = atw[j] + Ar[(long long)j * B] * w;
  }
  float rhs[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    rhs[j] = (j < n) ? (a.sigma * x[j] - q[j]) + atw[j] : 0.0f;
  float xt[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) xt[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      const float* Kj = a.Kinv + (long long)j * n * B + b;
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) xt[k] = xt[k] + rhs[j] * Kj[(long long)k * B];
    }
  }
  for (int r = 0; r < m; ++r) {
    const float* Ar = a.A + (long long)r * n * B + b;
    float zt = 0.0f;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) zt = zt + Ar[(long long)j * B] * xt[j];
    const int o = r * B + b;
    const float rho = a.rho[o], z = a.z[o], y = a.y[o], cap = a.cap[o];
    const float zm = a.alpha * zt + (1.0f - a.alpha) * z;
    const float v = zm + y * (1.0f / rho);
    const float zn = v - fminf(fmaxf(v - a.u[o], 0.0f), cap)
                     - fminf(fmaxf(v - a.l[o], -cap), 0.0f);
    a.z[o] = zn;
    a.y[o] = y + rho * (zm - zn);
  }
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    if (j < n) x[j] = a.alpha * xt[j] + (1.0f - a.alpha) * x[j];
}

// Unscaled residual statistics; returns this instance's convergence.
template <int NT>
__device__ __forceinline__ bool calc_stats(const Args& a, int b,
                                           const float (&x)[Dim<NT>::cap],
                                           float (&st)[8]) {
  constexpr int NMAX = Dim<NT>::cap;
  const int B = a.B, n = Dim<NT>::n(a.n), m = a.m;
  float aty[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) aty[j] = 0.0f;
  float s0 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int r = 0; r < m; ++r) {
    const float* Ar = a.A + (long long)r * n * B + b;
    const int o = r * B + b;
    const float y = a.y[o];
    float ax = 0.0f;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        const float Arj = Ar[(long long)j * B];
        ax = ax + Arj * x[j];
        aty[j] = aty[j] + Arj * y;
      }
    }
    const float invE = 1.0f / a.E[o];
    const float Ax_u = ax * invE, z_u = a.z[o] * invE;
    s0 = fmaxf(s0, fabsf(Ax_u - z_u));
    s2 = fmaxf(s2, fabsf(Ax_u));
    s3 = fmaxf(s3, fabsf(z_u));
  }
  float px[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) px[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      const float* Pj = a.PuD + (long long)j * n * B + b;
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) px[k] = px[k] + x[j] * Pj[(long long)k * B];
    }
  }
  float s1 = 0.0f, s4 = 0.0f, s5 = 0.0f, aqu = 0.0f;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      const float qu = a.qu[k * B + b];
      const float Aty_u = aty[k] * a.invDc[k * B + b];
      s1 = fmaxf(s1, fabsf(px[k] + qu + Aty_u));
      s4 = fmaxf(s4, fabsf(px[k]));
      s5 = fmaxf(s5, fabsf(Aty_u));
      aqu = fmaxf(aqu, fabsf(qu));
    }
  }
  st[0] = s0; st[1] = s1; st[2] = s2; st[3] = s3;
  st[4] = s4; st[5] = s5; st[6] = 0.0f; st[7] = 0.0f;
  const float eps_p = a.eps_abs + a.eps_rel * fmaxf(s2, s3);
  const float eps_d = a.eps_abs + a.eps_rel * fmaxf(fmaxf(s4, s5), aqu);
  return (s0 <= eps_p) && (s1 <= eps_d);
}

template <int NT>
__global__ void __launch_bounds__(GROUP, 1)
admm_kernel(Args a, int n_iters, int check) {
  constexpr int NMAX = Dim<NT>::cap;
  const int n = Dim<NT>::n(a.n);
  const int b = blockIdx.x * GROUP + threadIdx.x;
  const bool active = b < a.B;
  float x[NMAX], q[NMAX], st[8];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    x[j] = (active && j < n) ? a.x[j * a.B + b] : 0.0f;
    q[j] = (active && j < n) ? a.q[j * a.B + b] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = 0.0f;

  int executed;
  if (0 < check && check < n_iters) {
    const int n_blocks = (n_iters + check - 1) / check;
    int it = 0;
    bool done = false;
    while (!done && it < n_blocks) {       // uniform across the block
      const int k_len = min(check, n_iters - it * check);
      bool conv = true;
      if (active) {
        for (int t = 0; t < k_len; ++t) iterate<NT>(a, b, x, q);
        conv = calc_stats<NT>(a, b, x, st);
      }
      ++it;
      done = __syncthreads_and(conv) != 0;
    }
    executed = min(it * check, n_iters);
  } else {
    if (active) {
      for (int t = 0; t < n_iters; ++t) iterate<NT>(a, b, x, q);
      calc_stats<NT>(a, b, x, st);
    }
    executed = n_iters;
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    if (j < n) a.x[j * a.B + b] = x[j];
  st[6] = (float)executed;
#pragma unroll
  for (int i = 0; i < 8; ++i) a.stats[i * a.B + b] = st[i];
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
  if (n < 1 || n > NMAX || m < 1 || n_iters < 0 || check < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{Kinv, A, q, l, u, rho, cap, x, z, y, E, PuD, qu, invDc, stats,
         B, n, m, sigma, alpha, eps_abs, eps_rel};
  const int blocks = (B + GROUP - 1) / GROUP;
  if (n == 30)
    admm_kernel<30><<<blocks, GROUP, 0, (cudaStream_t)stream>>>(a, n_iters,
                                                               check);
  else
    admm_kernel<0><<<blocks, GROUP, 0, (cudaStream_t)stream>>>(a, n_iters,
                                                              check);
  return (int)cudaGetLastError();
}
