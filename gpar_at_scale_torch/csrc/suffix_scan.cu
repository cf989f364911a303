// Blocked suffix scan of affine + congruence elements: phase R1 (K4a) and
// phase R3 (K4b) for Hopper.
//
// Replaces the TPU kernels gpar_at_scale_tpu/ops/pallas_smoother.py::
// _r1_kernel (K4a) and ::_r3_kernel (K4b).  Given per-step elements
// (E_k (d, d), g_k (d, C), L_k (d, d)) the scan returns, for every k,
//
//     v_k = g_k + E_k v_{k+1},   M_k = L_k + E_k M_{k+1} E_k^T,
//     v_n = 0, M_n = 0,
//
// the backward recursion of the RTS smoother and of the disturbance
// smoother's adjoint (r, N) in the gradient.  The series is split into
// nblocks contiguous blocks of T steps, block b owning steps
// [b*T, min((b+1)*T, n)):
//
//   K4a: each block folds its elements from its last step to its first,
//        new = e_k o suffix = (E_k E_s, g_k + E_k g_s, L_k + E_k L_s E_k^T),
//        into one block element;
//   K4b: each block replays from its last step to its first, starting from
//        the exclusive suffix of the later blocks (g0, L0) -- computed
//        between the launches -- and writes (v_k, M_k) at every step.
//
// E and L are shared by the C columns; only g carries them.  So a launch
// has two kinds of thread: nblocks * C column threads (one per block and
// column; the columns of one block are neighbours in a warp, so their g
// and v rows are read and written coalesced and E_k is one broadcast), and
// after them nblocks matrix threads (one per block) that run the d x d
// E / L (K4a) or M (K4b) recursion.  The TPU kernel ran 1024 lanes in
// lockstep over a sequential grid; here the step loop runs inside each
// thread and the blocks in no order.  Steps at or past n do not exist: a
// block stops at n, which is the JAX kernels' identity padding.
//
// What bounds it: at the main path's C = 33 columns K4a reads
// 4 (2 d^2 + d C) bytes per step and K4b reads as much and writes
// 4 (d C + d^2) -- about 0.47 and 0.90 GB at n = 1e6, d = 3 -- for a few
// FMAs per byte, so bytes bound them.  Each thread is a chain of dependent
// steps; the card hides that latency with the 5e5 column threads in
// flight.  At C = 1 every thread reads its own block's rows (strided
// across a warp by T rows), as K1/K2 do.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int D>
__device__ __forceinline__ void load_mat(const float* __restrict__ X, long long k,
                                         float out[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = X[k * D * D + i * D + j];
}

// Ms <- Lk + Ek Ms Ek^T
template <int D>
__device__ __forceinline__ void congruence(const float Ek[D][D], const float Lk[D][D],
                                           float Ms[D][D]) {
  float EM[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int l = 0; l < D; ++l) s += Ek[i][l] * Ms[l][j];
      EM[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = Lk[i][j];
#pragma unroll
      for (int l = 0; l < D; ++l) s += EM[i][l] * Ek[j][l];
      Ms[i][j] = s;
    }
}

// v <- g_k[:, c] + Ek v
template <int D>
__device__ __forceinline__ void affine(const float* __restrict__ E, const float* __restrict__ g,
                                       long long k, int C, int c, float v[D]) {
  float Ek[D][D], gk[D];
  load_mat<D>(E, k, Ek);
#pragma unroll
  for (int i = 0; i < D; ++i) gk[i] = g[(k * D + i) * C + c];
  float out[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = gk[i];
#pragma unroll
    for (int j = 0; j < D; ++j) s += Ek[i][j] * v[j];
    out[i] = s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = out[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
suffix_reduce_kernel(const float* __restrict__ E, const float* __restrict__ g,
                     const float* __restrict__ L, long long n, long long T, int nblocks, int C,
                     float* __restrict__ bE, float* __restrict__ bg, float* __restrict__ bL) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long ncol = static_cast<long long>(nblocks) * C;
  if (tid < ncol) {
    const int blk = static_cast<int>(tid / C), c = static_cast<int>(tid % C);
    const long long start = static_cast<long long>(blk) * T;
    const long long stop = min(start + T, n);
    float v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = 0.0f;
    for (long long k = stop - 1; k >= start; --k) affine<D>(E, g, k, C, c, v);
#pragma unroll
    for (int i = 0; i < D; ++i) bg[(static_cast<long long>(blk) * D + i) * C + c] = v[i];
  } else if (tid < ncol + nblocks) {
    const int blk = static_cast<int>(tid - ncol);
    const long long start = static_cast<long long>(blk) * T;
    const long long stop = min(start + T, n);
    float Es[D][D], Ls[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        Es[i][j] = (i == j) ? 1.0f : 0.0f;
        Ls[i][j] = 0.0f;
      }
    for (long long k = stop - 1; k >= start; --k) {
      float Ek[D][D], Lk[D][D], En[D][D];
      load_mat<D>(E, k, Ek);
      load_mat<D>(L, k, Lk);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int l = 0; l < D; ++l) s += Ek[i][l] * Es[l][j];
          En[i][j] = s;
        }
      congruence<D>(Ek, Lk, Ls);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) Es[i][j] = En[i][j];
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        bE[static_cast<long long>(blk) * D * D + i * D + j] = Es[i][j];
        bL[static_cast<long long>(blk) * D * D + i * D + j] = Ls[i][j];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
suffix_replay_kernel(const float* __restrict__ E, const float* __restrict__ g,
                     const float* __restrict__ L, long long n, long long T, int nblocks, int C,
                     const float* __restrict__ g0, const float* __restrict__ L0,
                     float* __restrict__ v_out, float* __restrict__ M_out) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long ncol = static_cast<long long>(nblocks) * C;
  if (tid < ncol) {
    const int blk = static_cast<int>(tid / C), c = static_cast<int>(tid % C);
    const long long start = static_cast<long long>(blk) * T;
    const long long stop = min(start + T, n);
    float v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = g0[(static_cast<long long>(blk) * D + i) * C + c];
    for (long long k = stop - 1; k >= start; --k) {
      affine<D>(E, g, k, C, c, v);
#pragma unroll
      for (int i = 0; i < D; ++i) v_out[(k * D + i) * C + c] = v[i];
    }
  } else if (tid < ncol + nblocks) {
    const int blk = static_cast<int>(tid - ncol);
    const long long start = static_cast<long long>(blk) * T;
    const long long stop = min(start + T, n);
    float Ms[D][D];
    load_mat<D>(L0, blk, Ms);
    for (long long k = stop - 1; k >= start; --k) {
      float Ek[D][D], Lk[D][D];
      load_mat<D>(E, k, Ek);
      load_mat<D>(L, k, Lk);
      congruence<D>(Ek, Lk, Ms);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) M_out[k * D * D + i * D + j] = Ms[i][j];
    }
  }
}

dim3 grid_for(int nblocks, int C) {
  const long long threads = static_cast<long long>(nblocks) * (C + 1);
  return dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" int suffix_reduce(int d, const void* E, const void* g, const void* L, long long n,
                             long long T, int nblocks, int C, void* bE, void* bg, void* bL,
                             void* stream) {
  if (n < 1 || T < 1 || nblocks < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_for(nblocks, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_R1(DD)                                                                          \
  suffix_reduce_kernel<DD><<<grid, kThreads, 0, s>>>(                                        \
      static_cast<const float*>(E), static_cast<const float*>(g),                            \
      static_cast<const float*>(L), n, T, nblocks, C, static_cast<float*>(bE),               \
      static_cast<float*>(bg), static_cast<float*>(bL))
  switch (d) {
    case 1: GPAR_R1(1); break;
    case 2: GPAR_R1(2); break;
    case 3: GPAR_R1(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_R1
  return static_cast<int>(cudaGetLastError());
}

extern "C" int suffix_replay(int d, const void* E, const void* g, const void* L, long long n,
                             long long T, int nblocks, int C, const void* g0, const void* L0,
                             void* v_out, void* M_out, void* stream) {
  if (n < 1 || T < 1 || nblocks < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_for(nblocks, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_R3(DD)                                                                          \
  suffix_replay_kernel<DD><<<grid, kThreads, 0, s>>>(                                        \
      static_cast<const float*>(E), static_cast<const float*>(g),                            \
      static_cast<const float*>(L), n, T, nblocks, C, static_cast<const float*>(g0),         \
      static_cast<const float*>(L0), static_cast<float*>(v_out), static_cast<float*>(M_out))
  switch (d) {
    case 1: GPAR_R3(1); break;
    case 2: GPAR_R3(2); break;
    case 3: GPAR_R3(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_R3
  return static_cast<int>(cudaGetLastError());
}
