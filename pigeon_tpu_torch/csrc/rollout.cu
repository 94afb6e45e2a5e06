// Cumulative affine rollout M_0 = E_0, M_t = A_t M_{t-1} + E_t per
// instance, one thread per (instance, column of M).
//
// Replaces the TPU kernel pigeon_tpu/qp/condensed.py:_rollout_lane_kernel.
// The recursion is independent per column of M, so a thread carries its
// column (a d-vector) in registers through all T stages; nothing of the
// TPU kernel's (8, 128) blocks, width blocks or 1024-lane chunks remains.
//
// Layout: A (B, T, d, d), E and the output (B, T, d, w), row-major,
// d <= 6, T < 64.  A warp serves one instance: it copies the instance's
// T d x d matrices to shared memory once (each A_t is read from device
// memory once per instance, not once per column), then lane c walks
// columns c, c + 32, ...; for a fixed (t, row) the lanes read and write w
// consecutive floats.
//
// Bound on the card: every input read once and the output written once,
// 4 T d (d + 2 w) bytes and 2 T d^2 w FLOP per instance.  At B = 8192,
// T = 30, d = 4, w = 31 that is 259 MB against 0.24 GFLOP: bound by bytes
// (~0.08 ms).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // instances per block

template <int D>
__global__ void rollout_kernel(const float* __restrict__ A,
                               const float* __restrict__ E,
                               float* __restrict__ out, long long B, int T,
                               int w) {
  extern __shared__ float a_sh[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = blockIdx.x * (long long)WARPS + warp;
  if (b >= B) return;  // whole warp leaves; only warp-level sync follows
  float* As = a_sh + warp * T * D * D;
  const float* Ab = A + b * T * D * D;
  for (int e = lane; e < T * D * D; e += 32) As[e] = Ab[e];
  __syncwarp();

  const float* Eb = E + b * T * D * w;
  float* Ob = out + b * T * D * w;
  for (int c = lane; c < w; c += 32) {
    float M[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      M[i] = Eb[i * w + c];
      Ob[i * w + c] = M[i];
    }
    for (int t = 1; t < T; ++t) {
      const float* At = As + t * D * D;
      float Mn[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float acc = At[i * D] * M[0];
#pragma unroll
        for (int k = 1; k < D; ++k) acc += At[i * D + k] * M[k];
        Mn[i] = acc + Eb[(t * D + i) * w + c];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        M[i] = Mn[i];
        Ob[(t * D + i) * w + c] = Mn[i];
      }
    }
  }
}

template <int D>
int launch(const float* A, const float* E, float* out, long long B, int T,
           int w, cudaStream_t stream) {
  const long long blocks = (B + WARPS - 1) / WARPS;
  const size_t shared = (size_t)WARPS * T * D * D * sizeof(float);
  rollout_kernel<D><<<(unsigned)blocks, WARPS * 32, shared, stream>>>(
      A, E, out, B, T, w);
  return (int)cudaGetLastError();
}

}  // namespace

// A (B, T, d, d), E and out (B, T, d, w), float32.  Returns
// cudaGetLastError() (invalid value for a shape the kernel does not take).
extern "C" int rollout_f32(const float* A, const float* E, float* out,
                           long long B, int T, int d, int w, void* stream) {
  if (d < 1 || d > 6 || T < 1 || T >= 64 || w < 1 ||
      B > 4LL * 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch<1>(A, E, out, B, T, w, s);
    case 2: return launch<2>(A, E, out, B, T, w, s);
    case 3: return launch<3>(A, E, out, B, T, w, s);
    case 4: return launch<4>(A, E, out, B, T, w, s);
    case 5: return launch<5>(A, E, out, B, T, w, s);
    default: return launch<6>(A, E, out, B, T, w, s);
  }
}

// Resident blocks per SM (WARPS instances each) of the build for (T, d),
// with its shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *out.
extern "C" int rollout_blocks_per_sm(int T, int d, int* out) {
  if (d < 1 || d > 6 || T < 1 || T >= 64) return (int)cudaErrorInvalidValue;
  const void* fns[6] = {(const void*)rollout_kernel<1>,
                        (const void*)rollout_kernel<2>,
                        (const void*)rollout_kernel<3>,
                        (const void*)rollout_kernel<4>,
                        (const void*)rollout_kernel<5>,
                        (const void*)rollout_kernel<6>};
  const size_t shared = (size_t)WARPS * T * d * d * sizeof(float);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fns[d - 1], WARPS * 32, shared);
}
