// Structured Van Loan exponential of the MPC's FOH/ZOH stage
// augmentation, one thread per (instance, stage, row).
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
// Bound on the card: 193 floats of traffic per stage at n = 6 (772 B: 95
// MB per fleet step at B=8192, T=15) against ~10.9 kFLOP at order 6 and 4
// squarings (1.34 GFLOP): the bytes bound it (0.028 ms) just above the
// operations (0.020 ms).  The first design ran one thread per stage with
// every working matrix in registers (251 registers at n = 6, no spills, 2
// blocks of 128 threads an SM) and read and wrote the instance-major
// layout with a 144-byte stride between neighbouring threads: its stores
// alone took 61% of a thread's life.
//
// This design: the stages are cut into chunks of STAGES consecutive
// stages, whose input slabs (P0, Cu0, cc0, rr) are contiguous, and a
// resident block walks over chunks, copying the next chunk's slabs into
// shared memory (cp.async, 16 bytes a copy) while it computes on the
// current one.  Thread (stage, i) owns row i of the stage's working
// matrices and keeps P in registers, so the Taylor sums need no exchange;
// each squaring exchanges the rows of e11, X, Y and z through shared
// memory, laid out as the output slabs, which the block then stores with
// 16-byte writes.  Order and squarings are template parameters for the
// path's (6, 4); other values run the same code with run-time loops.
//
// Rounding: every sum of products is the chain the first design's
// compiler emitted for it -- fma(a0, b0, a1 b1), then one fma a term over
// k ascending -- written with __fmaf_rn / __fmul_rn, as is every update,
// so no contraction choice of the compiler moves a result.  The outputs
// are bit for bit the first design's at n = 4.  At n = 6 the first
// design's compiled code summed entry (1, 1) of e11^2 in a way no such
// chain reproduces, in under 0.3% of the stages; from there the outputs
// of a path differ by up to 4.8e-7.

#include <cuda_runtime.h>

namespace {

// stages a chunk holds, the threads of a block (a whole number of warps)
// and the resident blocks an SM its registers must allow
template <int N> struct Plan {
  static constexpr int STAGES = N == 6 ? 32 : 64;
  static constexpr int THREADS = STAGES * N;
  static constexpr int MIN_BLOCKS = N == 6 ? 3 : 4;
};

// floats of a chunk's input slabs (P0, Cu0, cc0, rr) and output slabs
// (A, X, Y, z)
template <int N, int M>
__host__ __device__ constexpr int in_floats() {
  return Plan<N>::STAGES * (N * N + N * M + N + 1);
}
template <int N, int M>
__host__ __device__ constexpr int out_floats() {
  return Plan<N>::STAGES * (N * N + 2 * N * M + N);
}
// shared floats of a block: two input buffers and the output slabs
template <int N, int M>
__host__ __device__ constexpr int smem_floats() {
  return 2 * in_floats<N, M>() + out_floats<N, M>();
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one group of copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// start copying `words` floats into shared memory, 16 bytes a copy when
// `vec` (both ends 16-byte aligned), then the tail
__device__ __forceinline__ void load_words(float* dst, const float* src,
                                           int words, bool vec) {
  int done = 0;
  if (vec) {
    const int w4 = words / 4;
    for (int q = threadIdx.x; q < w4; q += blockDim.x)
      cp_async16(dst + 4 * q, src + 4 * q);
    done = 4 * w4;
  }
  for (int q = done + threadIdx.x; q < words; q += blockDim.x)
    cp_async4(dst + q, src + q);
}

// store `words` floats from shared to device memory, 16 bytes at a time
// when `vec`, then the tail
__device__ __forceinline__ void store_words(float* dst, const float* src,
                                            int words, bool vec) {
  int done = 0;
  if (vec) {
    const int w4 = words / 4;
    for (int q = threadIdx.x; q < w4; q += blockDim.x)
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(src)[q];
    done = 4 * w4;
  }
  for (int q = done + threadIdx.x; q < words; q += blockDim.x)
    dst[q] = src[q];
}

// a row of W floats from shared memory (float4 or float2 where the row
// width allows it; rows start on a multiple of their vector size)
template <int W>
__device__ __forceinline__ void ld_row(const float* p, float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int q = 0; q < W / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = t.x;
      v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) v[q] = p[q];
  }
}

template <int W>
__device__ __forceinline__ void st_row(float* p, const float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int q = 0; q < W / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) p[q] = v[q];
  }
}

// sum_k a[k] b[k] for K >= 2: fma(a0, b0, a1 b1), then fma over k >= 2
template <int K>
__device__ __forceinline__ float dot(const float (&a)[K],
                                     const float (&b)[K]) {
  float acc = __fmaf_rn(a[0], b[0], __fmul_rn(a[1], b[1]));
#pragma unroll
  for (int k = 2; k < K; ++k) acc = __fmaf_rn(a[k], b[k], acc);
  return acc;
}

// out[j] = sum_k a[k] S[k][j] (S rows W floats apart in shared memory),
// each a `dot` chain
template <int N, int W>
__device__ __forceinline__ void row_times(const float (&a)[N],
                                          const float* S, float (&out)[W]) {
  float s0[W], s1[W];
  ld_row<W>(S, s0);
  ld_row<W>(S + W, s1);
#pragma unroll
  for (int j = 0; j < W; ++j)
    out[j] = __fmaf_rn(a[0], s0[j], __fmul_rn(a[1], s1[j]));
#pragma unroll
  for (int k = 2; k < N; ++k) {
    ld_row<W>(S + k * W, s0);
#pragma unroll
    for (int j = 0; j < W; ++j) out[j] = __fmaf_rn(a[k], s0[j], out[j]);
  }
}

// ORD, SQ > 0: the order and squarings fixed at compile time; 0: read
// from the arguments
template <int N, int M, int ORD, int SQ>
__global__ void __launch_bounds__(Plan<N>::THREADS, Plan<N>::MIN_BLOCKS)
vanloan_kernel(const float* __restrict__ P0, const float* __restrict__ Cu0,
               const float* __restrict__ cc0, const float* __restrict__ rr,
               float* __restrict__ Ao, float* __restrict__ Xo,
               float* __restrict__ Yo, float* __restrict__ zo,
               long long count, int squarings, int order, int vec) {
  constexpr int S = Plan<N>::STAGES, NN = N * N, NM = N * M;
  __shared__ __align__(16) float sm[smem_floats<N, M>()];
  float* sA = sm + 2 * in_floats<N, M>();   // outputs, as the global slabs
  float* sX = sA + S * NN;
  float* sY = sX + S * NM;
  float* sz = sY + S * NM;

  const int ord = ORD > 0 ? ORD : order;
  const int sqr = SQ > 0 ? SQ : squarings;
  const float s = ldexpf(1.0f, -sqr);
  const long long chunks = (count + S - 1) / S;
  // thread (st, i): row i of stage st of the chunk; the threads of a
  // stage beyond the ragged end compute on stale shared memory and store
  // nothing
  const int st = threadIdx.x / N, i = threadIdx.x % N;

  auto load_chunk = [&](long long c, float* in) {
    const long long s0 = c * S;
    const int cnt = (int)(count - s0 < S ? count - s0 : S);
    load_words(in, P0 + s0 * NN, cnt * NN, vec);
    load_words(in + S * NN, Cu0 + s0 * NM, cnt * NM, vec);
    load_words(in + S * (NN + NM), cc0 + s0 * N, cnt * N, vec);
    load_words(in + S * (NN + NM + N), rr + s0, cnt, vec);
  };

  int buf = 0;
  if (blockIdx.x < chunks) load_chunk(blockIdx.x, sm);
  cp_async_commit();
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    // the next chunk's copies overlap this chunk's work
    if (c + gridDim.x < chunks)
      load_chunk(c + gridDim.x, sm + (buf ^ 1) * in_floats<N, M>());
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* sP = sm + buf * in_floats<N, M>();
    const float* sC = sP + S * NN;
    const float* sc = sC + S * NM;
    const float* sr = sc + S * N;

    float P[N][N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ld_row<N>(sP + st * NN + k * N, P[k]);
#pragma unroll
      for (int j = 0; j < N; ++j) P[k][j] = __fmul_rn(P[k][j], s);
    }
    float Pj[N], e11[N], U[N], W[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float e = (i == j) ? 1.0f : 0.0f;
      Pj[j] = e;
      e11[j] = e;
      U[j] = e;
      W[j] = e * 0.5f;
    }
    double fact = 1.0;
#pragma unroll
    for (int j = 1; j <= ord; ++j) {
      float tmp[N];
#pragma unroll
      for (int b = 0; b < N; ++b) {
        float col[N];
#pragma unroll
        for (int k = 0; k < N; ++k) col[k] = P[k][b];
        tmp[b] = dot<N>(Pj, col);
      }
      fact *= j;
      const float c0 = (float)(1.0 / fact);
      const float c1 = (float)(1.0 / (fact * (j + 1)));
      const float c2 = (float)(1.0 / (fact * (j + 1) * (j + 2)));
#pragma unroll
      for (int b = 0; b < N; ++b) {
        Pj[b] = tmp[b];
        e11[b] = __fmaf_rn(tmp[b], c0, e11[b]);
        if (j <= ord - 1) U[b] = __fmaf_rn(tmp[b], c1, U[b]);
        if (j <= ord - 2) W[b] = __fmaf_rn(tmp[b], c2, W[b]);
      }
    }

    float X[M], Y[M], z;
    const float r = __fmul_rn(sr[st], s);
    {
      float Cu[M][N], cc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float row[M];
        ld_row<M>(sC + st * NM + k * M, row);
#pragma unroll
        for (int j = 0; j < M; ++j) Cu[j][k] = __fmul_rn(row[j], s);
      }
      ld_row<N>(sc + st * N, cc);
#pragma unroll
      for (int k = 0; k < N; ++k) cc[k] = __fmul_rn(cc[k], s);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        X[j] = dot<N>(U, Cu[j]);
        Y[j] = __fmul_rn(r, dot<N>(W, Cu[j]));
      }
      z = dot<N>(U, cc);
    }

    // squarings: the rows of e11, X, Y and z go through the output slabs
    float rcur = r;
    for (int q = 0; q < sqr; ++q) {
      st_row<N>(sA + st * NN + i * N, e11);
      st_row<M>(sX + st * NM + i * M, X);
      st_row<M>(sY + st * NM + i * M, Y);
      sz[st * N + i] = z;
      __syncthreads();
      float Xn[M], Yn[M], En[N], zrow[N];
      row_times<N, M>(e11, sX + st * NM, Xn);
      row_times<N, M>(e11, sY + st * NM, Yn);
      ld_row<N>(sz + st * N, zrow);
      const float zn = dot<N>(e11, zrow);
      row_times<N, N>(e11, sA + st * NN, En);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < M; ++j) {
        Y[j] = __fmaf_rn(rcur, X[j], __fadd_rn(Yn[j], Y[j]));
        X[j] = __fadd_rn(Xn[j], X[j]);
      }
      z = __fadd_rn(zn, z);
#pragma unroll
      for (int j = 0; j < N; ++j) e11[j] = En[j];
      rcur = __fmul_rn(rcur, 2.0f);
    }

    st_row<N>(sA + st * NN + i * N, e11);
    st_row<M>(sX + st * NM + i * M, X);
    st_row<M>(sY + st * NM + i * M, Y);
    sz[st * N + i] = z;
    __syncthreads();
    const long long s0 = c * S;
    const int cnt = (int)(count - s0 < S ? count - s0 : S);
    store_words(Ao + s0 * NN, sA, cnt * NN, vec);
    store_words(Xo + s0 * NM, sX, cnt * NM, vec);
    store_words(Yo + s0 * NM, sY, cnt * NM, vec);
    store_words(zo + s0 * N, sz, cnt * N, vec);
    // the output slabs and this input buffer are free again
    __syncthreads();
    buf ^= 1;
  }
}

template <int N, int M, int ORD, int SQ>
int launch(const float* P0, const float* Cu0, const float* cc0,
           const float* rr, float* A, float* X, float* Y, float* z,
           long long count, int squarings, int order, int vec,
           cudaStream_t stream) {
  // one wave of resident blocks, each walking over chunks
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vanloan_kernel<N, M, ORD, SQ>, Plan<N>::THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (count + Plan<N>::STAGES - 1) / Plan<N>::STAGES;
  const long long wave = (long long)sms * per_sm;
  const long long blocks = chunks < wave ? chunks : wave;
  vanloan_kernel<N, M, ORD, SQ><<<(unsigned)blocks, Plan<N>::THREADS, 0,
                                  stream>>>(P0, Cu0, cc0, rr, A, X, Y, z,
                                            count, squarings, order, vec);
  return (int)cudaGetLastError();
}

template <int N>
int dispatch(const float* P0, const float* Cu0, const float* cc0,
             const float* rr, float* A, float* X, float* Y, float* z,
             long long count, int squarings, int order, int vec,
             cudaStream_t stream) {
  if (order == 6 && squarings == 4)
    return launch<N, 6, 6, 4>(P0, Cu0, cc0, rr, A, X, Y, z, count,
                              squarings, order, vec, stream);
  return launch<N, 6, 0, 0>(P0, Cu0, cc0, rr, A, X, Y, z, count, squarings,
                            order, vec, stream);
}

bool aligned16(const void* p) { return ((size_t)p % 16) == 0; }

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
  const int vec = aligned16(P0) && aligned16(Cu0) && aligned16(cc0) &&
                  aligned16(rr) && aligned16(A) && aligned16(X) &&
                  aligned16(Y) && aligned16(z);
  cudaStream_t s = (cudaStream_t)stream;
  return n == 6 ? dispatch<6>(P0, Cu0, cc0, rr, A, X, Y, z, count,
                              squarings, order, vec, s)
                : dispatch<4>(P0, Cu0, cc0, rr, A, X, Y, z, count,
                              squarings, order, vec, s);
}

// The block plan of the (n, 6) build, into *out: field 0 the stages a
// chunk holds, 1 the threads of a block, 2 its shared bytes.
extern "C" int vanloan_plan(int n, int field, int* out) {
  int plan[3];
  if (n == 6) {
    plan[0] = Plan<6>::STAGES;
    plan[1] = Plan<6>::THREADS;
    plan[2] = 4 * smem_floats<6, 6>();
  } else if (n == 4) {
    plan[0] = Plan<4>::STAGES;
    plan[1] = Plan<4>::THREADS;
    plan[2] = 4 * smem_floats<4, 6>();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (field < 0 || field > 2) return (int)cudaErrorInvalidValue;
  *out = plan[field];
  return 0;
}

// Resident blocks per SM of the (n, 6) build at the path's order 6 and 4
// squarings (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out.
extern "C" int vanloan_blocks_per_sm(int n, int* out) {
  if (n == 6)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, vanloan_kernel<6, 6, 6, 4>, Plan<6>::THREADS, 0);
  if (n == 4)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, vanloan_kernel<4, 6, 6, 4>, Plan<4>::THREADS, 0);
  return (int)cudaErrorInvalidValue;
}
