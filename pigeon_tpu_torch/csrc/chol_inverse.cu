// Per-instance inverse of the ADMM KKT matrix K = P + sigma I + A' rho A,
// one warp per instance.
//
// Replaces the TPU kernel pigeon_tpu/solver/lane_admm.py:_chol_inv_kernel
// with the same steps: column Cholesky K = L L' (each column an outer-
// product update of the whole matrix), forward substitution W = L^-1,
// K^-1 = W' W, then `polish` Newton-Schulz steps X <- X (2I - K X).
//
// Layout: K and the output are (B, n, n), instance-major.  The warp loads
// its instance's K (3.6 KB at n = 30) coalesced, padded to 32 x 32 with an
// identity block (exact: the inverse is then diag(K^-1, I)), and lane i
// owns row i (column i for W).  Columns are broadcast through warp
// shuffles and two padded 32 x 33 shared-memory tiles per warp.
//
// Bound on the card: ~7.4 KB of traffic and ~0.13 MFLOP per instance (60
// MB and 1.1 GFLOP at B=8192), so the memory bound is ~18 us; the kernel
// is bound by its shuffle / shared-memory broadcast latency.

#include <cuda_runtime.h>

namespace {

constexpr int NP = 32;        // padded size: one lane per row
constexpr int LD = NP + 1;    // shared tile stride (no bank conflicts)
constexpr int WARPS = 4;      // instances per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void chol_inverse_kernel(const float* __restrict__ K,
                                    float* __restrict__ out, long long B,
                                    int n, int polish) {
  __shared__ float tiles[WARPS][2][NP * LD];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = blockIdx.x * (long long)WARPS + warp;
  if (b >= B) return;  // whole warp leaves; only warp-level sync follows
  float* S0 = tiles[warp][0];
  float* S1 = tiles[warp][1];
  const float* Kb = K + b * n * n;

  for (int e = lane; e < NP * NP; e += 32) {
    const int i = e / NP, j = e % NP;
    S0[i * LD + j] = (i < n && j < n) ? Kb[i * n + j]
                                      : ((i == j) ? 1.0f : 0.0f);
  }
  __syncwarp();

  float K0[NP], Kr[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    K0[j] = S0[lane * LD + j];
    Kr[j] = K0[j];
  }

  // Cholesky: lane holds row `lane` of the working matrix and of L
  float Lr[NP], dinv[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const float d = __shfl_sync(FULL, Kr[j], j);
    const float di = 1.0f / sqrtf(d);
    dinv[j] = di;
    const float c = (lane >= j) ? Kr[j] * di : 0.0f;
    Lr[j] = c;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float ck = __shfl_sync(FULL, c, k);
      Kr[k] = Kr[k] - c * ck;
    }
  }

  // forward substitution, lane = column c of W:
  // W[j][c] = (delta_jc - sum_{k<j} L[j][k] W[k][c]) / L[j][j]
#pragma unroll
  for (int k = 0; k < NP; ++k) S1[lane * LD + k] = Lr[k];
  __syncwarp();
  float Wc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc + S1[j * LD + k] * Wc[k];
    Wc[j] = (((j == lane) ? 1.0f : 0.0f) - acc) * dinv[j];
  }

  // X = W' W, lane = row a: X[a][b] = sum_k W[k][a] W[k][b]
#pragma unroll
  for (int k = 0; k < NP; ++k) S0[k * LD + lane] = Wc[k];
  __syncwarp();
  float Xr[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) Xr[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const float wk = Wc[k];
#pragma unroll
    for (int j = 0; j < NP; ++j) Xr[j] = Xr[j] + wk * S0[k * LD + j];
  }

  // Newton-Schulz polish: Z = 2I - K0 X, X <- X Z
  for (int p = 0; p < polish; ++p) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NP; ++j) S1[lane * LD + j] = Xr[j];
    __syncwarp();
    float Zr[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) acc = acc + K0[k] * S1[k * LD + j];
      Zr[j] = ((j == lane) ? 2.0f : 0.0f) - acc;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) S0[lane * LD + j] = Zr[j];
    __syncwarp();
    float Xn[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) acc = acc + Xr[k] * S0[k * LD + j];
      Xn[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) Xr[j] = Xn[j];
  }

  __syncwarp();
#pragma unroll
  for (int j = 0; j < NP; ++j) S1[lane * LD + j] = Xr[j];
  __syncwarp();
  float* ob = out + b * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    ob[e] = S1[i * LD + j];
  }
}

}  // namespace

extern "C" int chol_inverse_f32(const float* K, float* out, long long B,
                                int n, int polish, void* stream) {
  if (n < 1 || n > NP || polish < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const long long blocks = (B + WARPS - 1) / WARPS;
  chol_inverse_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                        (cudaStream_t)stream>>>(K, out, B, n, polish);
  return (int)cudaGetLastError();
}

// Resident blocks per SM (WARPS instances each;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int chol_inverse_blocks_per_sm(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, chol_inverse_kernel, WARPS * 32, 0);
}
