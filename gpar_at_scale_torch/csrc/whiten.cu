// Many-column Kalman whitening sweep (K3) for Hopper.
//
// Replaces the TPU kernel gpar_at_scale_tpu/ops/pallas_whiten.py::
// _whiten_kernel.  The covariance and gain recursion of the filter does not
// depend on the observations, so it is computed once (K1/K2 with y = 0) and
// handed over as one gain row per step,
//
//     gains[k] = [S, log S, mask, K (d), A[0, :] (d), M = (I - K H) A (d*d)],
//
// and only the affine mean recursion is run per column:
//
//     v_k = y_k - A_k[0, :] . m_{k-1},   alpha_k = v_k / sqrt(S_k) * mask_k
//     m_k = M_k m_{k-1} + K_k y_k          (kept where mask_k > 0.5)
//     ll += -1/2 mask_k (log 2 pi + log S_k + alpha_k^2)
//
// Given a non-NULL m_out it also writes every column's filtered mean m_k
// (n, d, B), which the whitened-Gram gradient needs (ops/grad.py); only the
// training path asks for it.  Warp 0 stores it straight from registers: for
// one step and state component the 32 lanes write 32 neighbouring floats.
//
// One thread of the first warp runs one column through all n steps; a CUDA
// block owns kCols = 32 columns.  Time goes in chunks of kChunk rows, double
// buffered in shared memory: while warp 0 runs chunk c from shared memory,
// warps 1-3 stage the gain rows and the columns' y values of chunk c + 1
// (shared by the whole block, read from device memory once) and write out
// the alpha rows of chunk c - 1, coalesced.  The dependent chain of a step
// then touches only registers and shared memory.
//
// What bounds it: with B = M + 1 = 33 columns on the main path the kernel
// runs two blocks, a sequential chain of n dependent steps per thread -- it
// is latency-bound, far from the (18 + 2 B) * 4 bytes per step the card
// could stream.  Splitting time into blocks as K1/K2 do, with the columns
// inside each block, is the fix and later performance work.  The means add
// 4 d B bytes per step of stores, which do not wait on the chain.
//
// Plain C interface (built with nvcc, loaded with ctypes): the entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kCols = 32;     // columns per block: warp 0 computes them
constexpr int kChunk = 64;    // time rows per shared-memory stage
constexpr int kThreads = 128; // warp 0 computes, warps 1-3 move data
constexpr int kMovers = kThreads - 32;

// Copy chunk rows [t0, t0 + rows) of the gain rows and of the block's y
// columns into shared memory, with COUNT threads (tid in [0, COUNT)).  All
// loads are issued before any store, so their latencies overlap.
template <int D, int COUNT>
__device__ __forceinline__ void stage_chunk(float* __restrict__ sg, float* __restrict__ sy,
                                            const float* __restrict__ gains,
                                            const float* __restrict__ Y, long long t0, int rows,
                                            int B, int col0, int ncols, int tid) {
  constexpr int G = 3 + 2 * D + D * D;
  constexpr int NG = (kChunk * G + COUNT - 1) / COUNT;
  constexpr int NY = (kChunk * kCols + COUNT - 1) / COUNT;
  float rg[NG], ry[NY];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int k = tid + i * COUNT;
    rg[i] = k < rows * G ? gains[t0 * G + k] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    const int k = tid + i * COUNT;
    const int r = k / kCols, j = k % kCols;
    ry[i] = (r < rows && j < ncols) ? Y[(t0 + r) * B + col0 + j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int k = tid + i * COUNT;
    if (k < kChunk * G) sg[k] = rg[i];
  }
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    const int k = tid + i * COUNT;
    if (k < kChunk * kCols) sy[k] = ry[i];
  }
}

// Write the alpha rows [t0, t0 + rows) of the block's columns from shared
// memory, with COUNT threads.
template <int COUNT>
__device__ __forceinline__ void drain_chunk(const float* __restrict__ sa,
                                            float* __restrict__ alpha, long long t0, int rows,
                                            int B, int col0, int ncols, int tid) {
  constexpr int NY = (kChunk * kCols + COUNT - 1) / COUNT;
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    const int k = tid + i * COUNT;
    const int r = k / kCols, j = k % kCols;
    if (r < rows && j < ncols) alpha[(t0 + r) * B + col0 + j] = sa[k];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
whiten_kernel(const float* __restrict__ gains, const float* __restrict__ Y, long long n, int B,
              float* __restrict__ alpha, float* __restrict__ ll, float* __restrict__ m_out) {
  constexpr int G = 3 + 2 * D + D * D;
  __shared__ float sg[2][kChunk * G];
  __shared__ float sy[2][kChunk * kCols];
  __shared__ float sa[2][kChunk * kCols];

  const int col0 = blockIdx.x * kCols;
  const int ncols = min(kCols, B - col0);
  const long long nchunks = (n + kChunk - 1) / kChunk;
  auto rows_of = [&](long long c) {
    return static_cast<int>(min(static_cast<long long>(kChunk), n - c * kChunk));
  };

  const int lane = threadIdx.x;
  float m[D];
#pragma unroll
  for (int i = 0; i < D; ++i) m[i] = 0.0f;
  // ll is summed per chunk in float and across chunks in double: a float
  // running sum over 1e6 steps loses about 1e-3 of its value.
  double acc = 0.0;

  stage_chunk<D, kThreads>(sg[0], sy[0], gains, Y, 0, rows_of(0), B, col0, ncols, threadIdx.x);
  __syncthreads();
  for (long long c = 0; c < nchunks; ++c) {
    const int buf = static_cast<int>(c & 1);
    if (threadIdx.x >= 32) {
      const int tid = threadIdx.x - 32;
      if (c + 1 < nchunks)
        stage_chunk<D, kMovers>(sg[buf ^ 1], sy[buf ^ 1], gains, Y, (c + 1) * kChunk,
                                rows_of(c + 1), B, col0, ncols, tid);
      if (c > 0)
        drain_chunk<kMovers>(sa[buf ^ 1], alpha, (c - 1) * kChunk, rows_of(c - 1), B, col0,
                             ncols, tid);
    } else if (lane < ncols) {
      const int rows = rows_of(c);
      const float* g = sg[buf];
      float part = 0.0f;
#pragma unroll 4
      for (int t = 0; t < rows; ++t, g += G) {
        const float S = g[0], logS = g[1], mask = g[2];
        const float yk = sy[buf][t * kCols + lane];
        float v = yk;
#pragma unroll
        for (int j = 0; j < D; ++j) v -= g[3 + D + j] * m[j];
        const float a = v * rsqrtf(S) * mask;
        float m_new[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = g[3 + i] * yk;
#pragma unroll
          for (int j = 0; j < D; ++j) s += g[3 + 2 * D + i * D + j] * m[j];
          m_new[i] = s;
        }
        if (mask > 0.5f) {
#pragma unroll
          for (int i = 0; i < D; ++i) m[i] = m_new[i];
        }
        if (m_out != nullptr) {
          const long long k = c * kChunk + t;
#pragma unroll
          for (int i = 0; i < D; ++i) m_out[(k * D + i) * B + col0 + lane] = m[i];
        }
        part -= 0.5f * mask * (kLog2Pi + logS + a * a);
        sa[buf][t * kCols + lane] = a;
      }
      acc += static_cast<double>(part);
    }
    __syncthreads();
  }
  drain_chunk<kThreads>(sa[(nchunks - 1) & 1], alpha, (nchunks - 1) * kChunk,
                        rows_of(nchunks - 1), B, col0, ncols, threadIdx.x);
  if (threadIdx.x < ncols) ll[col0 + threadIdx.x] = static_cast<float>(acc);
}

}  // namespace

extern "C" int whiten_columns(int d, const void* gains, const void* Y, long long n, int B,
                              void* alpha, void* ll, void* m_out, void* stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_W(DD)                                                                        \
  whiten_kernel<DD><<<grid, kThreads, 0, s>>>(static_cast<const float*>(gains),           \
                                              static_cast<const float*>(Y), n, B,         \
                                              static_cast<float*>(alpha),                 \
                                              static_cast<float*>(ll),                    \
                                              static_cast<float*>(m_out))
  switch (d) {
    case 1: GPAR_W(1); break;
    case 2: GPAR_W(2); break;
    case 3: GPAR_W(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_W
  return static_cast<int>(cudaGetLastError());
}
