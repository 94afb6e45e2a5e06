// Block-tridiagonal Cholesky stage recursion of the banded KKT factor:
// each instance's stage blocks in the registers of a half-warp, the block
// width fixed at compile time.
//
// Replaces the TPU kernel pigeon_tpu/solver/banded.py:_chol_lane_kernel.
// For stages t = 0 .. nb-1 (K_sub[0] == 0, Linv_{-1} = 0):
//   S_t    = K_sub[t] Linv_{t-1}'
//   D_t    = K_diag[t] - S_t S_t'
//   L_t    = chol(D_t), each pivot floored at 1e-12 before its square root
//   Linv_t = L_t^-1 (forward substitution against the identity)
// and writes Linv_t and S_t.  Layout: K_diag, K_sub, Linv, S are
// (B, nb, bw, bw), instance-major.
//
// Bound on the card (H100 SXM): 4 nb bw^2 floats of traffic per instance
// (43,264 B at nb = 16, bw = 13: 0.0264 ms at B = 2048 and 3.35 TB/s) and
// about 5 nb bw^3 operations.  Each instance is a chain of nb dependent
// stages, and at B = 2048 every instance is in flight at once, so one
// instance's chain sets the time; the design shortens it:
//   - SEG = 16 lanes own an instance (two a warp): lane i row i of the
//     stage's blocks (bw <= 16) and column i of Linv_t.  The rows of
//     K_diag[t], K_sub[t], S_t and D_t and the column of Linv_t sit in
//     registers, the loops over bw unrolled: bw is a template parameter,
//     a bw = 13 build for the sparse QP's stages and a 16 build for any
//     bw <= 16, whose padded rows and columns (identity in K_diag, zero in
//     K_sub) are exact fixed points of the recursion.
//   - The next stage's rows are loaded into registers while this stage
//     runs.
//   - Cross-lane values come by shuffle or from a shared-memory tile read
//     as broadcast float4s: Linv_{t-1} by rows for S_t, S_t transposed for
//     S_t S_t'.
//   - The Cholesky and the inverse run in one loop over the columns: once
//     column k of L_t is known it is broadcast by shuffles, and every lane
//     adds column k's term to its pending Cholesky sums (row role) and
//     forward-substitution sums (column role).
//   - The pivots' square roots and the divisions, the chain's longest
//     steps, run as the fast-path instructions of the IEEE operations
//     (fast_rn.cuh) with no branch; a stage in which any lane's operand
//     leaves their exact range is computed again with the IEEE operations.
// Every sum keeps the first design's order (k ascending, acc = acc + a b
// as one fma) and every division and square root is correctly rounded, as
// the first design's were, so the outputs are bit-equal to that design's.

#include <cuda_runtime.h>

#include "fast_rn.cuh"

namespace {

constexpr int BW_EXACT = 13;        // the sparse QP's stage width
constexpr int BW_MAX = 16;
constexpr int SEG = 16;             // lanes per instance
constexpr int PER_WARP = 32 / SEG;  // instances per warp
constexpr int LDT = 16;             // shared tile stride: float4 rows
constexpr int WARPS = 2;            // warps per block
constexpr unsigned FULL = 0xffffffffu;

// clamp(r, min=floor) that keeps a NaN, as torch.clamp and jnp.maximum do
__device__ __forceinline__ float floor_keep_nan(float r, float floor) {
  return (r >= floor || r != r) ? r : floor;
}

// a / b and sqrt(x) rounded to nearest.  FAST: the fast-path
// instructions alone, with `ok` cleared where an operand leaves their
// exact range (`used`: the lane keeps the quotient); otherwise the IEEE
// operations.
template <bool FAST>
__device__ __forceinline__ float div_rn(float a, float b, bool used,
                                        bool& ok) {
  if (!FAST) return a / b;
  ok &= !used || fast_rn::div_exact(a, b);
  return fast_rn::div_fast(a, b);
}

template <bool FAST>
__device__ __forceinline__ float sqrt_rn(float x, bool& ok) {
  if (!FAST) return sqrtf(x);
  ok &= fast_rn::sqrt_exact(x);
  return fast_rn::sqrt_fast(x);
}

// One stage's Cholesky (lane i: row i of L_t) and its inverse (lane i:
// column i of Linv_t, into x), column by column:
//   L[k][k] = sqrt(max(D[k][k] - ca_k[k], 1e-12)),
//   L[i][k] = (D[i][k] - ca_i[k]) / L[k][k]              (i > k)
//   X[k][i] = 1 / L[k][k] (k == i),  -xa_i[k] / L[k][k]  (k > i)
// with ca_i[j] = sum_{k<j} L[i][k] L[j][k] and
// xa_i[j] = sum_{i<=k<j} L[j][k] X[k][i], each term added when its column
// k is known, so each sum runs over k ascending.  Column k-1 of the
// inverse is computed after column k's pivot is requested, off the
// pivot chain.
template <int BW, bool FAST>
__device__ __forceinline__ void chol_inverse(const float (&drow)[BW], int i,
                                             float (&x)[BW], bool& ok) {
  float ca[BW], xa[BW], lprev[BW], dprev = 1.0f;
#pragma unroll
  for (int j = 0; j < BW; ++j) ca[j] = xa[j] = 0.0f;
#pragma unroll
  for (int k = 0; k <= BW; ++k) {
    float num = 0.0f, r = 0.0f;
    if (k < BW) {
      num = drow[k] - ca[k];
      r = __shfl_sync(FULL, num, k, SEG);
    }
    if (k > 0) {
      const int c = k - 1;
      const float xq = div_rn<FAST>((i == c) ? 1.0f : -xa[c], dprev, c >= i,
                                    ok);
      x[c] = (c < i) ? 0.0f : xq;
#pragma unroll
      for (int j = c + 1; j < BW; ++j)
        if (c >= i) xa[j] = fmaf(lprev[j], x[c], xa[j]);
    }
    if (k < BW) {
      const float d = sqrt_rn<FAST>(floor_keep_nan(r, 1e-12f), ok);
      const float lq = div_rn<FAST>(num, d, i > k, ok);
      const float lik = (i > k) ? lq : ((i == k) ? d : 0.0f);
#pragma unroll
      for (int j = k + 1; j < BW; ++j) {
        const float ljk = __shfl_sync(FULL, lik, j, SEG);
        ca[j] = fmaf(lik, ljk, ca[j]);
        lprev[j] = ljk;
      }
      dprev = d;
    }
  }
}

// Row i of the stage block at `src` (bw x bw) into v[0..BW): padded rows
// are the identity's (K_diag) or zero (K_sub).
template <int BW, bool PAD>
__device__ __forceinline__ void load_row(float (&v)[BW],
                                         const float* __restrict__ src,
                                         bool live, int i, int bw,
                                         bool diag) {
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    const bool real = live && i < bw && (!PAD || k < bw);
    v[k] = real ? __ldg(src + i * bw + k)
                : ((diag && i == k && i >= bw) ? 1.0f : 0.0f);
  }
}

template <int BW, bool PAD>
__global__ void __launch_bounds__(WARPS * 32)
banded_chol_kernel(const float* __restrict__ Kd, const float* __restrict__ Ks,
                   float* __restrict__ Linv, float* __restrict__ Sout,
                   long long B, int nb, int bw_arg) {
  __shared__ __align__(16) float Xs_all[WARPS * PER_WARP][BW * LDT];
  __shared__ __align__(16) float St_all[WARPS * PER_WARP][BW * LDT];
  const int bw = PAD ? bw_arg : BW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane / SEG, i = lane % SEG;
  const long long first = (blockIdx.x * (long long)WARPS + warp) * PER_WARP;
  if (first >= B) return;  // whole warp leaves; only warp-level sync follows
  const long long b = first + seg;
  const bool live = b < B;
  float* Xs = Xs_all[warp * PER_WARP + seg];  // Linv_{t-1}: row j at j LDT
  float* St = St_all[warp * PER_WARP + seg];  // S_t': St[k LDT + i] = S[i][k]
  const int bb = bw * bw;
  const long long base = live ? b * (long long)nb * bb : 0;

  for (int e = i; e < BW * LDT; e += SEG) Xs[e] = 0.0f;
  float kd[BW], ks[BW];
  load_row<BW, PAD>(kd, Kd + base, live, i, bw, true);
  load_row<BW, PAD>(ks, Ks + base, live, i, bw, false);

  for (int t = 0; t < nb; ++t) {
    const long long off = base + (long long)t * bb;
    float nkd[BW], nks[BW];
    const bool more = live && t + 1 < nb;
    load_row<BW, PAD>(nkd, Kd + off + bb, more, i, bw, true);
    load_row<BW, PAD>(nks, Ks + off + bb, more, i, bw, false);
    __syncwarp();

    // S_t row i: S[i][j] = sum_k K_sub[i][k] Linv_{t-1}[j][k]
    float s[BW];
#pragma unroll
    for (int j = 0; j < BW; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < BW; k4 += 4) {
        const float4 x = *reinterpret_cast<const float4*>(Xs + j * LDT + k4);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k4 + u < BW) acc = fmaf(ks[k4 + u], xv[u], acc);
      }
      s[j] = acc;
    }
    __syncwarp();  // every lane is done with Xs and the last stage's St
    if (i < BW) {
#pragma unroll
      for (int k = 0; k < BW; ++k) St[k * LDT + i] = s[k];
    }
    __syncwarp();
    if (live) {
      for (int e = i; e < bb; e += SEG)
        Sout[off + e] = St[(e % bw) * LDT + e / bw];
    }

    // D_t row i: D[i][j] = K_diag[i][j] - sum_k S[i][k] S[j][k]
    float dacc[BW];
#pragma unroll
    for (int j = 0; j < BW; ++j) dacc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < BW; ++k) {
#pragma unroll
      for (int j4 = 0; j4 < BW; j4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(St + k * LDT + j4);
        const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j4 + u < BW) dacc[j4 + u] = fmaf(s[k], sv[u], dacc[j4 + u]);
      }
    }
    float drow[BW];
#pragma unroll
    for (int j = 0; j < BW; ++j) drow[j] = kd[j] - dacc[j];

    // Cholesky and inverse: the fast instructions, and the IEEE operations
    // for the whole stage where an operand of some lane leaves their range
    float x[BW];
    bool ok = true;
    chol_inverse<BW, true>(drow, i, x, ok);
    if (__any_sync(FULL, !ok)) chol_inverse<BW, false>(drow, i, x, ok);
    if (i < BW) {
#pragma unroll
      for (int j = 0; j < BW; ++j) Xs[j * LDT + i] = x[j];
    }
    __syncwarp();
    if (live) {
      for (int e = i; e < bb; e += SEG)
        Linv[off + e] = Xs[(e / bw) * LDT + e % bw];
    }
#pragma unroll
    for (int k = 0; k < BW; ++k) {
      kd[k] = nkd[k];
      ks[k] = nks[k];
    }
  }
}

template <int BW, bool PAD>
int launch(const float* Kd, const float* Ks, float* Linv, float* S,
           long long B, int nb, int bw, void* stream) {
  constexpr long long per_block = WARPS * PER_WARP;
  const long long blocks = (B + per_block - 1) / per_block;
  banded_chol_kernel<BW, PAD>
      <<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
          Kd, Ks, Linv, S, B, nb, bw);
  return (int)cudaGetLastError();
}

bool valid(int bw, int build) {
  return build == BW_EXACT ? bw == BW_EXACT
                           : (build == BW_MAX && bw >= 1 && bw <= BW_MAX);
}

}  // namespace

// `build`: BW_EXACT for bw == BW_EXACT (the exact-width build), BW_MAX for
// any bw <= BW_MAX (the padded build); anything else is refused.
extern "C" int banded_chol_f32(const float* K_diag, const float* K_sub,
                               float* Linv, float* S, long long B, int nb,
                               int bw, int build, void* stream) {
  if (!valid(bw, build) || nb < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  return build == BW_EXACT
             ? launch<BW_EXACT, false>(K_diag, K_sub, Linv, S, B, nb, bw,
                                       stream)
             : launch<BW_MAX, true>(K_diag, K_sub, Linv, S, B, nb, bw,
                                    stream);
}

// Resident blocks per SM of that build (WARPS x PER_WARP instances each;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int banded_chol_blocks_per_sm(int bw, int build, int* out) {
  if (!valid(bw, build)) return (int)cudaErrorInvalidValue;
  const void* fn = build == BW_EXACT
                       ? (const void*)banded_chol_kernel<BW_EXACT, false>
                       : (const void*)banded_chol_kernel<BW_MAX, true>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn,
                                                            WARPS * 32, 0);
}
