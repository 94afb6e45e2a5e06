// Dense matrix exponential of a stack of small matrices by fixed
// scaling-and-squaring with a Horner Taylor sum: one thread block a
// matrix, one thread an entry.
//
// Replaces two TPU kernels of pigeon_tpu/discretize.py that compute the
// same chain: _expm_lane_kernel (instances on the lane axis) and
// _expm_chain_kernel (stages packed six to a 128 x 128 block-diagonal
// tile for the matrix unit).  The packing is an artifact of that unit
// and is dropped; per d x d block the result is the same:
//   S = M / 2^s;  E = I + S / order;
//   E = I + (S E) / k   for k = order-1 ... 1;   then s times  E = E E.
//
// Bound on the card: 8 d^2 bytes and 2 d^3 (order - 1 + s) FLOP per
// matrix.  The unbatched controller calls it on the 15 (d = 19) or 30
// (d = 17) stage matrices of one vehicle: 15 to 30 blocks on 132 SMs,
// where the time is the length of the chain of order - 1 + s = 9
// dependent products, not the operations.  The first design ran 128
// threads a matrix, each walking 3 of the 361 entries one after another
// with d and the entry's (i, j) known only at run time, and spent a
// product pass, a barrier, an update pass and a barrier on each Horner
// step.
//
// This design:
// - d^2 threads a matrix (12 warps at d = 19), so a product's critical
//   path is one chain of d FMAs;
// - d is a template parameter for the two path shapes (19 and 17), so
//   every sum is unrolled and every index a constant offset; the
//   run-time build (D = 0) takes any d <= 32 with the sums unrolled to 32
//   terms, leaving each at term d;
// - in the Horner phase thread (i, j) holds row i of S in registers, so an
//   FMA reads one shared word, E's column j: a warp's lanes read
//   neighbouring words or the same word.  A squaring first reloads row i
//   of the current E into registers;
// - E is double-buffered, so a product and its Horner update cost one
//   barrier; the update E = I + P / k is the product's epilogue, its
//   division through fast_rn.cuh (bit for bit `/`, without the slow-path
//   guard on the common path); the row stride of a tile is odd, so the
//   rows a warp touches lie on distinct banks;
// - M is read with one coalesced pass and the result leaves from
//   registers, coalesced.  A matrix is 1.4 KB: cp.async or TMA buy
//   nothing here.
// - No tensor cores: the chain needs fp32 products (the JAX kernels run
//   Precision.HIGHEST); TF32 wgmma would change the rounding, which the
//   squarings amplify by 2^s, and a wgmma is no shorter than the chain of
//   19 FMAs it would replace.
//
// Rounding: entry (i, j) of every product is a[i][0] b[0][j], then one
// fma a term over k ascending -- the chain the first design's compiler
// emitted -- written with __fmul_rn / __fmaf_rn, as is every update, so
// no contraction choice of the compiler moves a result, and the build
// chosen for a d does not change a bit.

#include <cuda_runtime.h>

#include "fast_rn.cuh"

namespace {

constexpr int D_MAX = 32;
// the builds exact in d; any other d <= D_MAX takes the run-time build 0
// (pigeon_tpu_torch.discretize.EXPM_BUILDS)
constexpr int EXACT_BUILDS[] = {19, 17};

// a thread per entry, in whole warps
__host__ __device__ constexpr int threads_for(int d) {
  return (d * d + 31) / 32 * 32;
}

// row stride of a shared tile: odd, so rows fall on distinct banks
__host__ __device__ constexpr int stride_for(int d) { return d | 1; }

// out[i][j] = sum_k a[k] b[k][j] for thread (i, j), in the chain's order:
// a[0] b[0][j], then one fma a term; `a` is row i in registers, `b` a
// tile in shared memory.  K is the unrolled length; the run-time build
// leaves the loop at k = d (a branch the whole block takes alike).
template <int K, bool EXACT>
__device__ __forceinline__ float row_times_tile(const float (&a)[K],
                                                const float* b, int d,
                                                int ld, int j) {
  float acc = __fmul_rn(a[0], b[j]);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (!EXACT && k >= d) break;
    acc = __fmaf_rn(a[k], b[k * ld + j], acc);
  }
  return acc;
}

template <int K, bool EXACT>
__device__ __forceinline__ void load_row(float (&r)[K], const float* t,
                                         int d, int ld, int i) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!EXACT && k >= d) break;
    r[k] = t[i * ld + k];
  }
}

// D > 0: the build for d == D; D == 0: any d <= D_MAX, given at run time
template <int D>
__global__ void __launch_bounds__(D > 0 ? threads_for(D) : 1024)
    expm_dense_kernel(const float* __restrict__ M, float* __restrict__ out,
                      int d_run, int squarings, int order) {
  constexpr bool EXACT = D > 0;
  constexpr int K = EXACT ? D : D_MAX;
  __shared__ float tiles[3][K * stride_for(K)];
  const int d = EXACT ? D : d_run;
  const int ld = stride_for(d);
  const int e = threadIdx.x;
  const int i = e / d, j = e - (e / d) * d;
  const bool live = e < d * d;
  const float one = i == j ? 1.0f : 0.0f;
  const long long base = (long long)blockIdx.x * d * d;
  float* S = tiles[0];
  float* E = tiles[1];
  float* F = tiles[2];

  // S = M / 2^s, E = I + S / order
  float val = 0.0f;
  if (live) {
    const float v = fast_rn::div(M[base + e], ldexpf(1.0f, squarings));
    S[i * ld + j] = v;
    val = __fadd_rn(one, fast_rn::div(v, (float)order));
    E[i * ld + j] = val;
  }
  __syncthreads();

  float r[K];
  if (live) load_row<K, EXACT>(r, S, d, ld, i);
  // E = I + (S E) / k: one barrier a step, E and F in turn
  for (int k = order - 1; k >= 1; --k) {
    if (live) {
      const float p = row_times_tile<K, EXACT>(r, E, d, ld, j);
      val = __fadd_rn(one, fast_rn::div(p, (float)k));
      F[i * ld + j] = val;
    }
    __syncthreads();
    float* t = E;
    E = F;
    F = t;
  }

  // E = E E; the last product stays in registers
  for (int q = 0; q < squarings; ++q) {
    const bool last = q + 1 == squarings;
    if (live) {
      load_row<K, EXACT>(r, E, d, ld, i);
      val = row_times_tile<K, EXACT>(r, E, d, ld, j);
      if (!last) F[i * ld + j] = val;
    }
    if (!last) {
      __syncthreads();
      float* t = E;
      E = F;
      F = t;
    }
  }
  if (live) out[base + e] = val;
}

bool is_build(int build) {
  if (build == 0) return true;
  for (int b : EXACT_BUILDS)
    if (b == build) return true;
  return false;
}

bool takes(int d, int build) {
  return d >= 1 && d <= D_MAX && is_build(build) && (build == 0 || build == d);
}

const void* kernel_of(int build) {
  switch (build) {
    case 19: return (const void*)expm_dense_kernel<19>;
    case 17: return (const void*)expm_dense_kernel<17>;
    default: return (const void*)expm_dense_kernel<0>;
  }
}

}  // namespace

// M, out: (count, d, d) float32.  `build` is 0 (run-time d) or d itself
// where an exact build exists (pigeon_tpu_torch.discretize.expm_build).
// Returns cudaGetLastError() (invalid value for a shape or build the
// kernel does not take).
extern "C" int expm_dense_f32(const float* M, float* out, long long count,
                              int d, int squarings, int order, int build,
                              void* stream) {
  if (!takes(d, build) || order < 1 || squarings < 0 ||
      count > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (count <= 0) return 0;
  void* args[] = {&M, &out, &d, &squarings, &order};
  const cudaError_t err =
      cudaLaunchKernel(kernel_of(build), dim3((unsigned)count),
                       dim3(threads_for(d)), args, 0, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Of `build` at d (build 0 or d), into *out: field 0 the resident blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), 1 the registers
// a thread.
extern "C" int expm_dense_occupancy(int build, int d, int field, int* out) {
  if (!takes(d, build) || field < 0 || field > 1)
    return (int)cudaErrorInvalidValue;
  if (field == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel_of(build), threads_for(d), 0);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(build));
  *out = attr.numRegs;
  return (int)err;
}
