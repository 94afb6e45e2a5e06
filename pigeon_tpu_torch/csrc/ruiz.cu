// Modified Ruiz equilibration of the sparse MPC QP plus cost scaling (OSQP
// semantics), one thread block per instance.
//
// Replaces the TPU kernel pigeon_tpu/solver/pallas_ruiz.py:_kernel, which
// computes the same function as pigeon_tpu/solver/admm.py:_ruiz (and the
// port's plain version, pigeon_tpu_torch/solver/admm.py:ruiz), for a
// diagonal P.  Per sweep (D = E = c = 1 at the start):
//   col_x[j] = max(|P_j| D_j^2 c, max_r |A_rj| E_r * D_j)
//   col_y[r] = max_j |A_rj| D_j * E_r
//   D_j /= sqrt(col_x[j])  and  E_r /= sqrt(col_y[r])
//          (a norm <= 1e-12 leaves its scale as it is)
//   g = max(mean_j |P_j| D_j^2 c, max_j c D_j |q_j|),  c /= max(g, 1)
// then writes E A D, P D^2 c, c D q, E l, E u, D, E and c.  Maxima keep
// NaN, as the plain version's amax does.
//
// The TPU kernel holds the instance's A in VMEM for all sweeps.  At
// m = 290, n = 193 one A is 224 KB, the whole of a block's shared memory,
// so here every sweep reads A from global memory: a column pass (thread
// per column, coalesced along the row) and a row pass (warp per row), and
// the final pass writes the scaled copy.  The 132 resident blocks' A
// (~30 MB) stay in the 50 MB L2 between passes, so device memory sees
// about one read and one write of A per instance.
//
// Bound on the card: 2 m n floats of traffic per instance (0.46 GB at
// B=2048, ~0.14 ms at 3.35 TB/s) and ~6 m n operations per sweep.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-12f;

// max that keeps a NaN of either argument
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

// scale /= sqrt(norm), leaving zero-norm rows and columns unscaled
__device__ __forceinline__ float rescale(float scale, float norm) {
  return scale / sqrtf(norm <= EPS ? 1.0f : norm);
}

__global__ void __launch_bounds__(THREADS)
ruiz_kernel(const float* __restrict__ P, const float* __restrict__ q,
            const float* __restrict__ A, const float* __restrict__ l,
            const float* __restrict__ u, float* __restrict__ Pb,
            float* __restrict__ qb, float* __restrict__ Ab,
            float* __restrict__ lb, float* __restrict__ ub,
            float* __restrict__ Dout, float* __restrict__ Eout,
            float* __restrict__ cout, int n, int m, int iters) {
  extern __shared__ float sh[];
  float* D = sh;                 // (n)
  float* E = D + n;              // (m)
  float* nx = E + m;             // (n) col_x of the sweep
  float* ny = nx + n;            // (m) col_y of the sweep
  float* red = ny + m;           // (2 WARPS) block reductions
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long b = blockIdx.x;
  const float* Pi = P + b * n;
  const float* qi = q + b * n;
  const float* Ai = A + b * (long long)m * n;

  for (int j = tid; j < n; j += THREADS) D[j] = 1.0f;
  for (int r = tid; r < m; r += THREADS) E[r] = 1.0f;
  float c = 1.0f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int j = tid; j < n; j += THREADS) {
      float cm = 0.0f;
#pragma unroll 4
      for (int r = 0; r < m; ++r)
        cm = nmax(cm, fabsf(Ai[(long long)r * n + j]) * E[r]);
      const float Dj = D[j];
      const float Ps = fabsf(Pi[j]) * Dj * Dj * c;
      nx[j] = nmax(Ps, cm * Dj);
    }
    for (int r = warp; r < m; r += WARPS) {
      const float* Ar = Ai + (long long)r * n;
      float rm = 0.0f;
      for (int j = lane; j < n; j += 32) rm = nmax(rm, fabsf(Ar[j]) * D[j]);
      rm = warp_max(rm);
      if (lane == 0) ny[r] = rm * E[r];
    }
    __syncthreads();
    for (int j = tid; j < n; j += THREADS) D[j] = rescale(D[j], nx[j]);
    for (int r = tid; r < m; r += THREADS) E[r] = rescale(E[r], ny[r]);
    __syncthreads();

    // cost scaling
    float s = 0.0f, qm = 0.0f;
    for (int j = tid; j < n; j += THREADS) {
      const float Dj = D[j];
      s += fabsf(Pi[j]) * Dj * Dj * c;
      qm = nmax(qm, c * Dj * fabsf(qi[j]));
    }
    s = warp_sum(s);
    qm = warp_max(qm);
    if (lane == 0) {
      red[warp] = s;
      red[WARPS + warp] = qm;
    }
    __syncthreads();
    float tot = 0.0f, qmax = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      tot += red[w];
      qmax = nmax(qmax, red[WARPS + w]);
    }
    const float g = nmax(tot / (float)n, qmax);
    c = c / nmax(g, 1.0f);
    __syncthreads();  // red is rewritten by the next sweep
  }

  float* Abi = Ab + b * (long long)m * n;
  const long long mn = (long long)m * n;
  for (long long e = tid; e < mn; e += THREADS) {
    const int r = (int)(e / n), j = (int)(e % n);
    Abi[e] = (E[r] * Ai[e]) * D[j];
  }
  for (int j = tid; j < n; j += THREADS) {
    const float Dj = D[j];
    Pb[b * n + j] = Pi[j] * Dj * Dj * c;
    qb[b * n + j] = c * Dj * qi[j];
    Dout[b * n + j] = Dj;
  }
  for (int r = tid; r < m; r += THREADS) {
    const long long o = b * m + r;
    lb[o] = E[r] * l[o];
    ub[o] = E[r] * u[o];
    Eout[o] = E[r];
  }
  if (tid == 0) cout[b] = c;
}

}  // namespace

extern "C" int ruiz_f32(const float* P, const float* q, const float* A,
                        const float* l, const float* u, float* Pb, float* qb,
                        float* Ab, float* lb, float* ub, float* D, float* E,
                        float* c, int B, int n, int m, int iters,
                        void* stream) {
  if (n < 1 || m < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const size_t shmem = (size_t)(2 * n + 2 * m + 2 * WARPS) * sizeof(float);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ruiz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  ruiz_kernel<<<B, THREADS, shmem, (cudaStream_t)stream>>>(
      P, q, A, l, u, Pb, qb, Ab, lb, ub, D, E, c, n, m, iters);
  return (int)cudaGetLastError();
}
