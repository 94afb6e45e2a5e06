// Block-tridiagonal Cholesky stage recursion of the banded KKT factor, one
// warp per instance.
//
// Replaces the TPU kernel pigeon_tpu/solver/banded.py:_chol_lane_kernel.
// For stages t = 0 .. nb-1 (K_sub[0] == 0, Linv_{-1} = 0):
//   S_t    = K_sub[t] Linv_{t-1}'
//   D_t    = K_diag[t] - S_t S_t'
//   L_t    = chol(D_t), each pivot floored at 1e-12 before its square root
//   Linv_t = L_t^-1 (forward substitution against the identity)
// and writes Linv_t and S_t.  The TPU kernel puts 128 instances on the
// vector lanes; here a warp owns an instance, and lane i owns row i of the
// stage's bw x bw blocks (bw <= 16), which sit in padded shared-memory
// tiles.  The Cholesky runs column by column (the pivot is broadcast by a
// shuffle), the inverse column by column with one lane per column (no
// exchange between lanes).
//
// Layout: K_diag, K_sub, Linv, S are (B, nb, bw, bw), instance-major; bw
// and nb are run-time arguments.
//
// Bound on the card: 4 nb bw^2 floats of traffic (~11 KB at nb = 16,
// bw = 13) and ~0.1 MFLOP per instance, ~7 us of device memory at B=2048;
// the kernel is bound by the latency of its dependent column steps
// (nb (2 bw) short steps, each behind a warp barrier).

#include <cuda_runtime.h>

namespace {

constexpr int BWMAX = 16;
constexpr int LD = BWMAX + 1;       // shared tile stride
constexpr int TILE = BWMAX * LD;
constexpr int WARPS = 4;            // instances per block
constexpr unsigned FULL = 0xffffffffu;

// clamp(r, min=floor) that keeps a NaN, as torch.clamp and jnp.maximum do
__device__ __forceinline__ float floor_keep_nan(float r, float floor) {
  return (r >= floor || r != r) ? r : floor;
}

__global__ void __launch_bounds__(WARPS * 32)
banded_chol_kernel(const float* __restrict__ Kd, const float* __restrict__ Ks,
                   float* __restrict__ Linv, float* __restrict__ Sout,
                   long long B, int nb, int bw) {
  __shared__ float smem[WARPS][5][TILE];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = blockIdx.x * (long long)WARPS + warp;
  if (b >= B) return;  // whole warp leaves; only warp-level sync follows
  float* D = smem[warp][0];     // K_diag[t], then D_t in place
  float* Ko = smem[warp][1];    // K_sub[t]
  float* Sm = smem[warp][2];    // S_t
  float* Lm = smem[warp][3];    // L_t
  float* Xc = smem[warp][4];    // Linv_t (and Linv_{t-1} before it)
  const int bb = bw * bw;
  const long long base = b * (long long)nb * bb;

  for (int e = lane; e < TILE; e += 32) Xc[e] = 0.0f;
  __syncwarp();

  for (int t = 0; t < nb; ++t) {
    const long long off = base + (long long)t * bb;
    for (int e = lane; e < bb; e += 32) {
      const int i = e / bw, j = e % bw;
      D[i * LD + j] = Kd[off + e];
      Ko[i * LD + j] = Ks[off + e];
    }
    __syncwarp();

    // S_t = K_sub[t] Linv_{t-1}': lane i computes row i
    if (lane < bw) {
      for (int j = 0; j < bw; ++j) {
        float acc = 0.0f;
        for (int k = 0; k < bw; ++k)
          acc = acc + Ko[lane * LD + k] * Xc[j * LD + k];
        Sm[lane * LD + j] = acc;
      }
    }
    __syncwarp();
    // D_t = K_diag[t] - S_t S_t' (row i of D is lane i's alone)
    if (lane < bw) {
      for (int j = 0; j < bw; ++j) {
        float acc = 0.0f;
        for (int k = 0; k < bw; ++k)
          acc = acc + Sm[lane * LD + k] * Sm[j * LD + k];
        D[lane * LD + j] = D[lane * LD + j] - acc;
      }
    }
    __syncwarp();

    // Cholesky, column by column
    for (int j = 0; j < bw; ++j) {
      float acc = 0.0f;
      if (lane < bw) {
        for (int k = 0; k < j; ++k)
          acc = acc + Lm[lane * LD + k] * Lm[j * LD + k];
      }
      // lane j's acc is the sum of squares of row j
      const float r = D[j * LD + j] - __shfl_sync(FULL, acc, j);
      const float d = sqrtf(floor_keep_nan(r, 1e-12f));
      if (lane < bw) {
        float v;
        if (lane > j)
          v = (D[lane * LD + j] - acc) / d;
        else
          v = (lane == j) ? d : 0.0f;
        Lm[lane * LD + j] = v;
      }
      __syncwarp();
    }

    // Linv_t: lane c computes column c
    //   X[c][c] = 1 / L[c][c];  X[j][c] = -(sum_{k<j} L[j][k] X[k][c]) / L[j][j]
    if (lane < bw) {
      const int c = lane;
      for (int j = 0; j < bw; ++j) {
        float v;
        if (j < c) {
          v = 0.0f;
        } else if (j == c) {
          v = 1.0f / Lm[j * LD + j];
        } else {
          float acc = 0.0f;
          for (int k = c; k < j; ++k) acc = acc + Lm[j * LD + k] * Xc[k * LD + c];
          v = (-acc) / Lm[j * LD + j];
        }
        Xc[j * LD + c] = v;
      }
    }
    __syncwarp();
    for (int e = lane; e < bb; e += 32) {
      const int i = e / bw, j = e % bw;
      Linv[off + e] = Xc[i * LD + j];
      Sout[off + e] = Sm[i * LD + j];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int banded_chol_f32(const float* K_diag, const float* K_sub,
                               float* Linv, float* S, long long B, int nb,
                               int bw, void* stream) {
  if (bw < 1 || bw > BWMAX || nb < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const long long blocks = (B + WARPS - 1) / WARPS;
  banded_chol_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                       (cudaStream_t)stream>>>(K_diag, K_sub, Linv, S, B, nb,
                                               bw);
  return (int)cudaGetLastError();
}
