// Per-instance inverse of the ADMM KKT matrix K = P + sigma I + A' rho A,
// one warp per instance.
//
// Replaces the TPU kernel pigeon_tpu/solver/lane_admm.py:_chol_inv_kernel
// with the same steps: column Cholesky K = L L' (each column an outer-
// product update of the trailing matrix), forward substitution W = L^-1,
// K^-1 = W' W, then `polish` Newton-Schulz steps X <- X (2I - K X).
//
// Layout: K and the output are (B, n, n), instance-major.  The warp loads
// its instance's K (3.6 KB at n = 30; 16-byte loads where n*n allows)
// into a shared tile padded to 32 x 32 with an identity block (exact: the
// inverse is then diag(K^-1, I)), rows 33 words apart so that a column is
// read without bank conflicts.  The Cholesky and the substitution give
// lane i row i of L and column i of W (broadcasts by shuffle and shared
// rows); the three 32 x 32 x 32 products -- W'W and the polish's K X and
// X Z -- give lane l a 4 x 8 output tile, rows 4 (l / 4) to 4 (l / 4) + 3
// and columns 4 (l % 4) + {0..3, 16..19}, read from shared tiles 16 bytes
// at a time; with that column split a warp's 16-byte row stores of a tile
// fall on distinct banks.
//
// Bound on the card: 7.2 KB of traffic and ~0.13 MFLOP per instance at
// n = 30 (59 MB and 1.1 GFLOP at B=8192): the bytes bound it, 0.018 ms.
// What sets the time is the shared-memory and shuffle traffic from which
// the FMAs take their operands: the SM returns 128 bytes of it a cycle to
// the lanes, so a warp's 16-byte shared load (512 bytes) costs four
// cycles even when every lane reads one address -- broadcasting rows as
// float4 in place of floats hardly moved the time.  A product that
// streams every operand through every lane (the first design: one load or
// shuffle per FMA, 191 registers, 8 warps an SM) is bound by that pipe at
// a quarter of the FMA rate; a 4 x 8 tile reads 12 floats a lane for 32
// FMAs, a row of 32 reads 32.  The Cholesky updates only the trailing
// columns (the entries k <= j are never read again).
//
// Every entry keeps the first design's fma chain over k ascending from +0
// (written with __fmaf_rn, so no contraction choice of the compiler can
// move it), and a skipped update is never read again, so the output is
// bit for bit the first design's.

#include <cuda_runtime.h>

namespace {

constexpr int NP = 32;        // padded size: one lane per row
constexpr int LK = 33;        // row stride of the K tile in words
constexpr int LD = 36;        // row stride of the other tiles (16 bytes)
constexpr int WARPS = 2;      // instances per block
// shared floats a warp: the K tile and two 16-byte-row tiles
constexpr int WARP_FLOATS = NP * LK + 2 * NP * LD;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// column q of the lane's tile
__device__ __forceinline__ int tile_col(int cb, int q) {
  return (q < 4 ? 0 : 12) + 4 * cb + q;
}

// The lane's 4 x 8 tile of A B, rows 4 rb + r, columns tile_col(cb, q):
// each entry sum_k A[.][k] B[k][.] over k ascending, one fma each from
// +0.  Bs
// holds B in a 16-byte-row tile; A is read as its transpose from such a
// tile (A_ROWS false: row k = column k of A) or by rows from the K tile.
template <bool A_ROWS>
__device__ __forceinline__ void tile_product(const float* A, const float* Bs,
                                             int rb, int cb,
                                             float (&c)[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) c[r][q] = 0.0f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float av[4];
    if (A_ROWS) {
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = A[(4 * rb + r) * LK + k];
    } else {
      const float4 a = ld4(A + k * LD + 4 * rb);
      av[0] = a.x;
      av[1] = a.y;
      av[2] = a.z;
      av[3] = a.w;
    }
    const float4 b0 = ld4(Bs + k * LD + 4 * cb);
    const float4 b1 = ld4(Bs + k * LD + 16 + 4 * cb);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) c[r][q] = __fmaf_rn(av[r], bv[q], c[r][q]);
  }
}

// the tile into S (row-major) and, if ST, its transpose into ST
__device__ __forceinline__ void store_tile(float* S, float* ST, int rb,
                                           int cb, const float (&c)[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    st4(S + (4 * rb + r) * LD + 4 * cb, c[r][0], c[r][1], c[r][2], c[r][3]);
    st4(S + (4 * rb + r) * LD + 16 + 4 * cb, c[r][4], c[r][5], c[r][6],
        c[r][7]);
  }
  if (ST != nullptr) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      st4(ST + tile_col(cb, q) * LD + 4 * rb, c[0][q], c[1][q], c[2][q],
          c[3][q]);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
chol_inverse_kernel(const float* __restrict__ K, float* __restrict__ out,
                    long long B, int n, int polish, int vec) {
  __shared__ __align__(16) float smem[WARPS][WARP_FLOATS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = blockIdx.x * (long long)WARPS + warp;
  if (b >= B) return;  // whole warp leaves; only warp-level sync follows
  float* S0 = smem[warp];        // K0, padded; kept for the polish
  float* S1 = S0 + NP * LK;
  float* S2 = S1 + NP * LD;
  const int nn = n * n;
  const float* Kb = K + b * nn;
  const int rb = lane / 4, cb = lane % 4;   // the lane's product tile

  // identity padding, then K's entries: every load of the instance
  // issued before the first is waited on (16 bytes a lane where n*n
  // allows)
  for (int e = lane; e < NP * NP; e += 32) {
    const int i = e / NP, j = e % NP;
    if (i >= n || j >= n) S0[i * LK + j] = (i == j) ? 1.0f : 0.0f;
  }
  if (vec) {
    float4 v[NP * NP / 128];
#pragma unroll
    for (int t = 0; t < NP * NP / 128; ++t)
      if (lane + 32 * t < nn / 4)
        v[t] = reinterpret_cast<const float4*>(Kb)[lane + 32 * t];
#pragma unroll
    for (int t = 0; t < NP * NP / 128; ++t) {
      const int e = 4 * (lane + 32 * t);
      if (e < nn) {
        const float vv[4] = {v[t].x, v[t].y, v[t].z, v[t].w};
        int i = e / n, j = e - i * n;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          S0[i * LK + j] = vv[u];
          if (++j == n) {
            j = 0;
            ++i;
          }
        }
      }
    }
  } else {
    float v[NP];
#pragma unroll
    for (int t = 0; t < NP; ++t)
      if (lane + 32 * t < nn) v[t] = Kb[lane + 32 * t];
#pragma unroll
    for (int t = 0; t < NP; ++t) {
      const int e = lane + 32 * t;
      if (e < nn) S0[(e / n) * LK + e % n] = v[t];
    }
  }
  __syncwarp();

  // Cholesky: lane holds row `lane` of the working matrix, and of L as
  // the columns are done.  Column j updates only the trailing columns
  // k > j: the working entries k <= j are never read again.
  float Kr[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) Kr[k] = S0[lane * LK + k];
  float Lr[NP], dinv[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const float d = __shfl_sync(FULL, Kr[j], j);
    const float di = 1.0f / sqrtf(d);
    dinv[j] = di;
    const float c = (lane >= j) ? Kr[j] * di : 0.0f;
    Lr[j] = c;
#pragma unroll
    for (int k = j + 1; k < NP; ++k) {
      const float ck = __shfl_sync(FULL, c, k);
      Kr[k] = __fmaf_rn(-c, ck, Kr[k]);
    }
  }

  // forward substitution, lane = column c of W:
  // W[j][c] = (delta_jc - sum_{k<j} L[j][k] W[k][c]) / L[j][j]
#pragma unroll
  for (int q = 0; q < NP / 4; ++q)
    st4(S1 + lane * LD + 4 * q, Lr[4 * q], Lr[4 * q + 1], Lr[4 * q + 2],
        Lr[4 * q + 3]);
  __syncwarp();
  float Wc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < (j + 3) / 4; ++q) {
      const float4 s = ld4(S1 + j * LD + 4 * q);
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t < j) acc = __fmaf_rn(sv[t], Wc[4 * q + t], acc);
    }
    Wc[j] = (((j == lane) ? 1.0f : 0.0f) - acc) * dinv[j];
  }

  // X = W' W: W's rows are both operands' shared rows
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NP; ++k) S1[k * LD + lane] = Wc[k];
  __syncwarp();
  float x[4][8];
  tile_product<false>(S1, S1, rb, cb, x);

  // Newton-Schulz polish: Z = 2I - K0 X, X <- X Z
  for (int p = 0; p < polish; ++p) {
    __syncwarp();
    store_tile(S2, S1, rb, cb, x);          // X, and X transposed
    __syncwarp();
    float z[4][8];
    tile_product<true>(S0, S2, rb, cb, z);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        z[r][q] = ((4 * rb + r == tile_col(cb, q)) ? 2.0f : 0.0f) - z[r][q];
    __syncwarp();
    store_tile(S2, nullptr, rb, cb, z);     // Z over X
    __syncwarp();
    tile_product<false>(S1, S2, rb, cb, x);
  }

  __syncwarp();
  store_tile(S2, nullptr, rb, cb, x);
  __syncwarp();
  float* ob = out + b * nn;
  if (vec) {
    for (int e4 = lane; e4 < nn / 4; e4 += 32) {
      float vv[4];
      int i = (4 * e4) / n, j = 4 * e4 - i * n;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        vv[u] = S2[i * LD + j];
        if (++j == n) {
          j = 0;
          ++i;
        }
      }
      reinterpret_cast<float4*>(ob)[e4] =
          make_float4(vv[0], vv[1], vv[2], vv[3]);
    }
  } else {
    for (int e = lane; e < nn; e += 32) ob[e] = S2[(e / n) * LD + e % n];
  }
}

}  // namespace

extern "C" int chol_inverse_f32(const float* K, float* out, long long B,
                                int n, int polish, void* stream) {
  if (n < 1 || n > NP || polish < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  // 16-byte loads and stores need every instance's n*n floats to start on
  // a 16-byte boundary
  const int vec = (n * n) % 4 == 0 && ((size_t)K % 16) == 0 &&
                  ((size_t)out % 16) == 0;
  const long long blocks = (B + WARPS - 1) / WARPS;
  chol_inverse_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                        (cudaStream_t)stream>>>(K, out, B, n, polish, vec);
  return (int)cudaGetLastError();
}

// Resident blocks per SM (WARPS instances each;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int chol_inverse_blocks_per_sm(int* out) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, chol_inverse_kernel, WARPS * 32, 0);
}

// The block plan, into *out: field 0 the instances a block takes, 1 its
// shared bytes.
extern "C" int chol_inverse_plan(int field, int* out) {
  if (field == 0) {
    *out = WARPS;
  } else if (field == 1) {
    *out = (int)(sizeof(float) * WARPS * WARP_FLOATS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}
