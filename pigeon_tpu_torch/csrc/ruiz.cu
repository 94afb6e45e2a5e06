// Modified Ruiz equilibration of the sparse MPC QP plus cost scaling (OSQP
// semantics): each instance's A read from device memory once, held in
// shared memory for every sweep, and written scaled once.  An instance's
// rows are split over a thread block cluster.
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
// Bound on the card (H100 SXM): one read and one write of A, 2 m n floats
// per instance (0.458 GB each way at B = 2048, m = 290, n = 193: 0.27 ms
// at 3.35 TB/s); the operations (about 6 m n a sweep) are far below it.
// The TPU kernel holds A in VMEM for all sweeps; so does this one.  One
// instance's A (223,880 B at the path's shape) would fill a block's 227 KB
// alone, and its load, sweeps and write would run in series on an SM, so
// the instance's m rows are split over a cluster of `cluster` blocks
// (ceil(m / cluster) rows each, `smem_bytes`; 6 at the path's shape, the
// fastest of 3..8 on the card) and several clusters' phases overlap:
//   - each block loads its rows, and every block the instance's P and q,
//     with 4-byte cp.async (a row is n floats, 772 B at n = 193, so rows
//     and instances are only 4-byte aligned);
//   - column maxima are partial per block (a thread per column over the
//     block's rows) and combined through distributed shared memory after
//     one cluster barrier per sweep; the partials are double-buffered by
//     the sweep's parity.  Row maxima are local to a block (a thread per
//     row and quarter of the columns), and run between the barrier's
//     arrive and wait.  Every max is exact in any order;
//   - D, c and the cost scaling are computed identically in every block;
//     E by the block that owns the row; the square roots and divisions by
//     fast_rn.cuh (correctly rounded, as `/` and sqrtf).
// Still, shared memory holds about one instance per SM, so an SM's load
// and write of one instance hardly overlap its sweeps: the design's floor
// lies above the bound.  The cost scaling's sum over n keeps the first
// design's tree (thread t of 256 adds j = t, t + 256, ...; the xor
// butterfly; the warps in order), so the outputs stay bit-equal to that
// design's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fast_rn.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER_MAX = 8;           // the portable cluster size
constexpr int SMEM_MAX = 232448;         // 227 KB: a block's opt-in limit
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-12f;

struct Args {
  const float* __restrict__ P;   // (B, n) diagonal
  const float* __restrict__ q;   // (B, n)
  const float* __restrict__ A;   // (B, m, n)
  const float* __restrict__ l;   // (B, m)
  const float* __restrict__ u;   // (B, m)
  float* __restrict__ Pb;
  float* __restrict__ qb;
  float* __restrict__ Ab;
  float* __restrict__ lb;
  float* __restrict__ ub;
  float* __restrict__ D;
  float* __restrict__ E;
  float* __restrict__ c;         // (B,)
  int n, m, iters, cluster;
};

__host__ __device__ inline int rows_per_block(int m, int cluster) {
  return (m + cluster - 1) / cluster;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// the row pass splits each row into QUARTERS column ranges
constexpr int QUARTERS = 4;

// Shared memory of one block, floats in this order, each vector rounded
// up to 4 floats (16-byte aligned for float4 reads): D, P, q, the column
// partials by sweep parity (2 n); the row partials of the column ranges
// (QUARTERS R) and E (R); the block reduction (2 WARPS); then the block's
// R rows of A (R n).
__host__ __device__ inline size_t smem_bytes(int n, int m, int cluster) {
  const size_t R = (size_t)rows_per_block(m, cluster);
  return 4 * (5 * (size_t)round4(n) + (QUARTERS + 1) * (size_t)round4((int)R)
              + 2 * WARPS + R * (size_t)n);
}

// max that keeps a NaN of either argument, one instruction (max.NaN); it
// agrees with the plain version's amax on every value compared here,
// since the only zeros among them are +0
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
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
  return fast_rn::div(scale, fast_rn::sqrt(norm <= EPS ? 1.0f : norm));
}

// the cluster barrier in two halves: arrive (release this block's shared
// writes) and wait (acquire the others')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__global__ void __launch_bounds__(THREADS) ruiz_kernel(Args a) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, m = a.m, C = a.cluster;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / C;
  const int R = rows_per_block(m, C);
  const int r0 = min(m, rank * R);
  const int rows = min(m, r0 + R) - r0;

  const int n4 = round4(n), R4 = round4(R);
  float* D = sh;                  // (n)
  float* P = D + n4;              // (n)
  float* q = P + n4;              // (n)
  float* part = q + n4;           // (2, n) column partials by sweep parity
  float* rowpart = part + 2 * n4; // (QUARTERS, R) row partials
  float* E = rowpart + QUARTERS * R4;  // (R) this block's rows
  float* red = E + R4;            // (2 WARPS) block reductions
  float* As = red + 2 * WARPS;    // (R, n) this block's rows of A
  // the row pass's column ranges: cw columns each (a multiple of 4)
  const int cw = round4((n + QUARTERS - 1) / QUARTERS);

  const long long arow = b * m + r0;             // first global row
  const float* Ag = a.A + arow * n;
  for (int e = tid; e < rows * n; e += THREADS) cp_async4(As + e, Ag + e);
  for (int j = tid; j < n; j += THREADS) {
    cp_async4(P + j, a.P + b * n + j);
    cp_async4(q + j, a.q + b * n + j);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = tid; j < n; j += THREADS) D[j] = 1.0f;
  for (int r = tid; r < rows; r += THREADS) E[r] = 1.0f;
  float c = 1.0f;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    float* mine = part + (it & 1) * n4;
    // Each pass runs four independent chains.  Column partials over this
    // block's rows: a thread per column (consecutive threads, consecutive
    // words); the row pass's items continue where the columns end, so the
    // threads share the work.
    for (int j = tid; j < n; j += THREADS) {
      float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
      int r = 0;
      for (; r + 4 <= rows; r += 4) {
        const float4 e = *reinterpret_cast<const float4*>(E + r);
        m0 = nmax(m0, fabsf(As[r * n + j]) * e.x);
        m1 = nmax(m1, fabsf(As[(r + 1) * n + j]) * e.y);
        m2 = nmax(m2, fabsf(As[(r + 2) * n + j]) * e.z);
        m3 = nmax(m3, fabsf(As[(r + 3) * n + j]) * e.w);
      }
      for (; r < rows; ++r) m0 = nmax(m0, fabsf(As[r * n + j]) * E[r]);
      mine[j] = nmax(nmax(m0, m1), nmax(m2, m3));
    }
    // the row pass is local: it runs while the cluster's blocks arrive
    cluster_arrive();
    // Row partials: a thread per (row, column range); n is odd, so
    // consecutive rows fall in distinct banks.
    const int first = n % THREADS;
    for (int t = (tid - first + THREADS) % THREADS; t < QUARTERS * rows;
         t += THREADS) {
      const int qr = t / rows, r = t - qr * rows;
      const int j0 = min(n, qr * cw), j1 = min(n, j0 + cw);
      const float* Ar = As + r * n;
      float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
      int j = j0;
      for (; j + 4 <= j1; j += 4) {
        const float4 d = *reinterpret_cast<const float4*>(D + j);
        m0 = nmax(m0, fabsf(Ar[j]) * d.x);
        m1 = nmax(m1, fabsf(Ar[j + 1]) * d.y);
        m2 = nmax(m2, fabsf(Ar[j + 2]) * d.z);
        m3 = nmax(m3, fabsf(Ar[j + 3]) * d.w);
      }
      for (; j < j1; ++j) m0 = nmax(m0, fabsf(Ar[j]) * D[j]);
      rowpart[qr * R4 + r] = nmax(nmax(m0, m1), nmax(m2, m3));
    }
    __syncthreads();  // rowpart written and D read by the whole block
    cluster_wait();
    float s = 0.0f, qm = 0.0f;
    for (int j = tid; j < n; j += THREADS) {
      float v[CLUSTER_MAX];
#pragma unroll
      for (int k = 0; k < CLUSTER_MAX; ++k)
        v[k] = k < C ? *cluster.map_shared_rank(mine + j, k) : 0.0f;
      float cm = 0.0f;
#pragma unroll
      for (int k = 0; k < CLUSTER_MAX; ++k) cm = nmax(cm, v[k]);
      const float Dj = D[j];
      const float Ps = fabsf(P[j]) * Dj * Dj * c;
      const float Dn = rescale(Dj, nmax(Ps, cm * Dj));
      D[j] = Dn;
      // the cost scaling's terms of the new D, the same in every block
      s += fabsf(P[j]) * Dn * Dn * c;
      qm = nmax(qm, c * Dn * fabsf(q[j]));
    }
    for (int r = tid; r < rows; r += THREADS) {
      const float Er = E[r];
      float rm = 0.0f;
#pragma unroll
      for (int k = 0; k < QUARTERS; ++k) rm = nmax(rm, rowpart[k * R4 + r]);
      E[r] = rescale(Er, rm * Er);
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
    const float g = nmax(fast_rn::div(tot, (float)n), qmax);
    c = fast_rn::div(c, nmax(g, 1.0f));
    // red is next written after the next sweep's cluster barrier
  }
  // done with the other blocks' partials; they may still read ours
  cluster_arrive();

  // E A D for this block's rows: consecutive threads, consecutive words
  float* Abg = a.Ab + arow * n;
  const int dr = THREADS / n, dj = THREADS % n;
  int r = tid / n, j = tid % n;
  for (int e = tid; e < rows * n; e += THREADS) {
    Abg[e] = (E[r] * As[e]) * D[j];
    r += dr;
    j += dj;
    if (j >= n) {
      j -= n;
      ++r;
    }
  }
  for (int rr = tid; rr < rows; rr += THREADS) {
    const long long o = arow + rr;
    a.lb[o] = E[rr] * a.l[o];
    a.ub[o] = E[rr] * a.u[o];
    a.E[o] = E[rr];
  }
  if (rank == 0) {
    for (int jj = tid; jj < n; jj += THREADS) {
      const float Dj = D[jj];
      a.Pb[b * n + jj] = P[jj] * Dj * Dj * c;
      a.qb[b * n + jj] = c * Dj * q[jj];
      a.D[b * n + jj] = Dj;
    }
    if (tid == 0) a.c[b] = c;
  }
  // no block leaves while another may still read its partials
  cluster_wait();
}

cudaLaunchConfig_t launch_config(int B, int cluster, size_t shmem,
                                 cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t prepare(int n, int m, int cluster, size_t* shmem) {
  if (n < 1 || m < 1 || cluster < 1 || cluster > CLUSTER_MAX)
    return cudaErrorInvalidValue;
  *shmem = smem_bytes(n, m, cluster);
  if (*shmem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(ruiz_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*shmem);
}

}  // namespace

extern "C" int ruiz_f32(const float* P, const float* q, const float* A,
                        const float* l, const float* u, float* Pb, float* qb,
                        float* Ab, float* lb, float* ub, float* D, float* E,
                        float* c, int B, int n, int m, int iters, int cluster,
                        void* stream) {
  size_t shmem = 0;
  cudaError_t err = prepare(n, m, cluster, &shmem);
  if (err != cudaSuccess || iters < 0)
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Args a{P, q, A, l, u, Pb, qb, Ab, lb, ub, D, E, c, n, m, iters, cluster};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, cluster, shmem, attr,
                                               stream);
  err = cudaLaunchKernelEx(&cfg, ruiz_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of this kernel the card holds at once for (n, m)
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int ruiz_max_clusters(int n, int m, int cluster, int* out) {
  size_t shmem = 0;
  cudaError_t err = prepare(n, m, cluster, &shmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, cluster, shmem, attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, ruiz_kernel, &cfg);
}
