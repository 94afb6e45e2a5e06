// Dense matrix exponential of a stack of small matrices by fixed
// scaling-and-squaring with a Horner Taylor sum, one thread block per
// matrix.
//
// Replaces two TPU kernels of pigeon_tpu/discretize.py that compute the
// same chain: _expm_lane_kernel (instances on the lane axis) and
// _expm_chain_kernel (stages packed six to a 128 x 128 block-diagonal
// tile for the matrix unit).  The packing is an artifact of that unit
// and is dropped; per d x d block the result is the same:
//   S = M / 2^s;  E = I + S / order;
//   E = I + (S E) / k   for k = order-1 ... 1;   then s times  E = E E.
//
// Layout: M and the output are (count, d, d), row-major, d <= 32.  The
// block keeps S, E and one scratch tile in shared memory (stride 33, so
// a column walk hits distinct banks) for the whole chain: each matrix is
// read once and written once, and every product of the chain is this
// kernel's own loop.  Thread e of the block owns the entries e, e + 128,
// ... of the d x d result.
//
// Bound on the card: 8 d^2 bytes and 2 d^3 (order - 1 + s) FLOP per
// matrix.  For 122,880 matrices of 19 x 19 at order 6, 4 squarings that
// is 355 MB and 15.2 GFLOP: bound by operations (0.23 ms at the fp32
// peak against 0.11 ms for the bytes).  The unbatched controller calls it
// on 15 or 30 matrices, where the launch sets the time.

#include <cuda_runtime.h>

namespace {

constexpr int D_MAX = 32;
constexpr int LD = D_MAX + 1;
constexpr int THREADS = 128;

// out = a b for d x d tiles in shared memory
__device__ __forceinline__ void tile_product(const float* a, const float* b,
                                             float* out, int d) {
  for (int e = threadIdx.x; e < d * d; e += THREADS) {
    const int i = e / d, j = e % d;
    float acc = a[i * LD] * b[j];
    for (int k = 1; k < d; ++k) acc += a[i * LD + k] * b[k * LD + j];
    out[i * LD + j] = acc;
  }
}

__global__ void expm_dense_kernel(const float* __restrict__ M,
                                  float* __restrict__ out, int d,
                                  int squarings, int order) {
  __shared__ float tiles[3][D_MAX * LD];
  float* S = tiles[0];
  float* E = tiles[1];
  float* P = tiles[2];
  const float* Mk = M + (long long)blockIdx.x * d * d;
  const float s = ldexpf(1.0f, squarings);

  for (int e = threadIdx.x; e < d * d; e += THREADS) {
    const int i = e / d, j = e % d;
    const float v = Mk[e] / s;
    S[i * LD + j] = v;
    E[i * LD + j] = (i == j ? 1.0f : 0.0f) + v / (float)order;
  }
  __syncthreads();

  for (int k = order - 1; k >= 1; --k) {
    tile_product(S, E, P, d);
    __syncthreads();
    for (int e = threadIdx.x; e < d * d; e += THREADS) {
      const int i = e / d, j = e % d;
      E[i * LD + j] = (i == j ? 1.0f : 0.0f) + P[i * LD + j] / (float)k;
    }
    __syncthreads();
  }

  for (int q = 0; q < squarings; ++q) {
    tile_product(E, E, P, d);
    __syncthreads();
    float* t = E;
    E = P;
    P = t;
  }

  float* Ok = out + (long long)blockIdx.x * d * d;
  for (int e = threadIdx.x; e < d * d; e += THREADS)
    Ok[e] = E[(e / d) * LD + e % d];
}

}  // namespace

// M, out: (count, d, d) float32.  Returns cudaGetLastError() (invalid
// value for a shape the kernel does not take).
extern "C" int expm_dense_f32(const float* M, float* out, long long count,
                              int d, int squarings, int order,
                              void* stream) {
  if (d < 1 || d > D_MAX || order < 1 || squarings < 0 ||
      count > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (count <= 0) return 0;
  expm_dense_kernel<<<(unsigned)count, THREADS, 0, (cudaStream_t)stream>>>(
      M, out, d, squarings, order);
  return (int)cudaGetLastError();
}

// Resident blocks per SM, one matrix a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int expm_dense_blocks_per_sm(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, expm_dense_kernel, THREADS, 0);
}
