// Structured Van Loan exponential of the MPC's FOH/ZOH stage
// augmentation, one thread per (instance, stage).
//
// Replaces the TPU kernel pigeon_tpu/discretize.py:_vanloan_lane_kernel.
// Computes, per stage (see pigeon_tpu_torch/discretize.py):
//   P = P0/2^s, Cu = Cu0/2^s, cc = cc0/2^s, r = rr/2^s
//   e11 = sum_{j<=order} P^j/j!, U = sum_{j<=order-1} P^j/(j+1)!,
//   W = sum_{j<=order-2} P^j/(j+2)!   (U starts at I, W at I/2)
//   X = U Cu, Y = r W Cu, z = U cc, then s squarings
//   X' = e11 X + X, Y' = e11 Y + Y + r_cur X, z' = e11 z + z, e11' = e11^2.
// A ZOH stage (r = 0) gives Y exactly 0.
//
// Bound on the card: ~0.8 KB of traffic and ~12 kFLOP per stage (95 MB
// and 1.5 GFLOP per fleet step at B=8192, T=15) -- neither bound is near,
// so the kernel is latency-bound; the n x n working matrices live in
// registers (and local memory where they spill).

#include <cuda_runtime.h>

namespace {

template <int R, int K, int C>
__device__ __forceinline__ void mm(const float (&a)[R][K],
                                   const float (&b)[K][C],
                                   float (&out)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float acc = a[i][0] * b[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) acc += a[i][k] * b[k][j];
      out[i][j] = acc;
    }
}

template <int N, int M>
__global__ void vanloan_kernel(const float* __restrict__ P0,
                               const float* __restrict__ Cu0,
                               const float* __restrict__ cc0,
                               const float* __restrict__ rr,
                               float* __restrict__ Ao,
                               float* __restrict__ Xo,
                               float* __restrict__ Yo,
                               float* __restrict__ zo,
                               long long count, int squarings, int order) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= count) return;
  const float s = ldexpf(1.0f, -squarings);

  float P[N][N], Pj[N][N], e11[N][N], U[N][N], W[N][N], tmp[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      P[i][j] = P0[k * N * N + i * N + j] * s;
      const float e = (i == j) ? 1.0f : 0.0f;
      Pj[i][j] = e;
      e11[i][j] = e;
      U[i][j] = e;
      W[i][j] = e * 0.5f;
    }

  double fact = 1.0;
  for (int j = 1; j <= order; ++j) {
    mm(Pj, P, tmp);
    fact *= j;
    const float c0 = (float)(1.0 / fact);
    const float c1 = (float)(1.0 / (fact * (j + 1)));
    const float c2 = (float)(1.0 / (fact * (j + 1) * (j + 2)));
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = 0; b < N; ++b) {
        Pj[a][b] = tmp[a][b];
        e11[a][b] = e11[a][b] + tmp[a][b] * c0;
        if (j <= order - 1) U[a][b] = U[a][b] + tmp[a][b] * c1;
        if (j <= order - 2) W[a][b] = W[a][b] + tmp[a][b] * c2;
      }
  }

  float Cu[N][M], cc[N][1], X[N][M], Y[N][M], z[N][1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) Cu[i][j] = Cu0[k * N * M + i * M + j] * s;
    cc[i][0] = cc0[k * N + i] * s;
  }
  const float r = rr[k] * s;
  mm(U, Cu, X);
  mm(W, Cu, Y);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) Y[i][j] = r * Y[i][j];
  mm(U, cc, z);

  float rcur = r;
  float Xn[N][M], Yn[N][M], zn[N][1];
  for (int q = 0; q < squarings; ++q) {
    mm(e11, X, Xn);
    mm(e11, Y, Yn);
    mm(e11, z, zn);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        Yn[i][j] = Yn[i][j] + Y[i][j] + rcur * X[i][j];
        Xn[i][j] = Xn[i][j] + X[i][j];
      }
      zn[i][0] = zn[i][0] + z[i][0];
    }
    mm(e11, e11, tmp);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        X[i][j] = Xn[i][j];
        Y[i][j] = Yn[i][j];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) e11[i][j] = tmp[i][j];
      z[i][0] = zn[i][0];
    }
    rcur = rcur * 2.0f;
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) Ao[k * N * N + i * N + j] = e11[i][j];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Xo[k * N * M + i * M + j] = X[i][j];
      Yo[k * N * M + i * M + j] = Y[i][j];
    }
    zo[k * N + i] = z[i][0];
  }
}

}  // namespace

// count = instances * stages; built for (n, m) = (6, 6), the coupled
// tracking model, and (4, 6), the decoupled lateral model.  Returns
// cudaGetLastError() (invalid value for any other shape).
extern "C" int vanloan_f32(const float* P0, const float* Cu0,
                           const float* cc0, const float* rr, float* A,
                           float* X, float* Y, float* z, long long count,
                           int n, int m, int squarings, int order,
                           void* stream) {
  if (m != 6 || (n != 6 && n != 4) || order < 2 || squarings < 0)
    return (int)cudaErrorInvalidValue;
  if (count <= 0) return 0;
  const int threads = 128;
  const long long blocks = (count + threads - 1) / threads;
  if (n == 6)
    vanloan_kernel<6, 6><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        P0, Cu0, cc0, rr, A, X, Y, z, count, squarings, order);
  else
    vanloan_kernel<4, 6><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        P0, Cu0, cc0, rr, A, X, Y, z, count, squarings, order);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the (n, 6) build, 128 threads a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int vanloan_blocks_per_sm(int n, int* out) {
  if (n != 6 && n != 4) return (int)cudaErrorInvalidValue;
  const void* fn = n == 6 ? (const void*)vanloan_kernel<6, 6>
                          : (const void*)vanloan_kernel<4, 6>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, 128, 0);
}
