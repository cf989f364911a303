// Small dense Cholesky factorization and triangular solves (K6a, K6b, K6c)
// for Hopper.
//
// Replaces the TPU kernels of gpar_at_scale_tpu/ops/pallas_dense.py:
//
//   dense_chol_solve  (K6a, _chol_solve_kernel)  S = U^T U with U upper,
//                     W = U^-T B (forward substitution), logdet S, and a
//                     per-matrix info word: 0, or j + 1 for the first pivot
//                     j that is not positive (as torch.linalg.cholesky_ex);
//   dense_tri_ut      (K6b, _tri_ut_kernel)      X = U^-T B;
//   dense_tri_u       (K6c, _tri_u_kernel)       X = U^-1 B.
//
// float32, row-major, 1 <= n <= 512 (PALLAS_DENSE_N_MAX), k >= 0 right-hand
// sides.  The semantics of the TPU kernels are kept so both packages give
// the same numbers: the pivot's inverse square root is rsqrt(max(pivot,
// 1e-30)), the factor's diagonal is pivot * rsqrt(...), the logdet sums
// log(max(U_jj, 1e-30)) (here in double, in row order), and a solve
// multiplies by the reciprocal of the diagonal.  Left out as TPU idioms: the
// 8-row sublane panels with constant one-hot lane masks, the identity
// padding to a multiple of 8, the transpose done as a product with eye, and
// the nilpotent log-depth inverse of the diagonal blocks.
//
// Design.  One thread block per matrix; the grid's third axis indexes a
// batch of matrices (the stride between them is n * n and n * k).  A 256 x
// 256 matrix (256 KB) does not fit in the 227 KB of shared memory a block
// may use, so the factorization is right-looking over panels of kNB = 16
// rows: the current panel sits in shared memory, the trailing matrix stays
// in device memory (in U's own buffer, upper triangle only), where it lives
// in the 50 MB L2.  Per panel:
//   1. the panel's rows are factored column by column in shared memory, one
//      barrier per column, the rank-1 update of the panel's later rows
//      spread over all threads by row and column;
//   2. the panel's rows of the right-hand side are solved, one thread per
//      column for the kNB x kNB diagonal block (a substitution in
//      registers), then every later row is updated by all threads, by row
//      and by column, in tiles of kKT = 64 columns;
//   3. the trailing matrix takes the rank-kNB update, spread over all
//      threads by row and column.
// K6b and K6c run steps 2 alone, K6c from the last panel up and with U's
// columns as coefficients.  Their right-hand-side columns are independent,
// so a second grid axis gives each block kKT of them.
//
// What bounds it on this card: latency, not bytes or operations.  At n = 256
// the work is 5.6 MFLOP of Cholesky (0.08 us at the float32 rate) and 1.4 MB
// of traffic (0.4 us at 3.35 TB/s), but the factorization is a chain of n
// dependent pivots with a block-wide barrier each, and every panel adds
// three more barriers and a pass over the L2-resident trailing matrix.  The
// design keeps each pivot step in shared memory (no device-memory access
// between the per-column barriers), keeps all 512 threads busy on the
// updates, and keeps kBatch rows' loads in flight per thread so the passes
// over device memory are not a chain of L2 round trips; it does not remove
// the pivot chain.  A batch of matrices (the next ROADMAP item) fills the
// other SMs.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 16;        // panel rows
constexpr int kKT = 64;        // right-hand-side columns per tile
constexpr int kThreads = 512;
constexpr int kNMax = 512;
constexpr int kGroups = kThreads / kKT;  // row groups of an update
constexpr int kBatch = 8;                // rows whose loads are in flight at once
constexpr float kTiny = 1e-30f;

// The update of later rows by one panel, for the columns [c0, c0 + cw):
//     X[i, c] -= sum_q Ps[q * n + i] * x_q(c),  x_q(c) = xs[q * xld + c - c0],
// for rows i in [first, end), and with kUpper only rows i <= c (the trailing
// matrix's upper triangle).  Thread (g, cc) owns column c0 + cc, keeps its
// x_q in registers and takes every kGroups-th row: a warp shares its row, so
// the coefficients are shared-memory broadcasts and the row's columns are
// one coalesced access.  The loads of kBatch rows are issued before any
// store, so their latencies (the L2 for device memory) overlap.
template <bool kUpper>
__device__ __forceinline__ void update_rows(const float* __restrict__ Ps, int nbp, int n,
                                            const float* __restrict__ xs, int xld,
                                            float* __restrict__ X, long long ldx, int first,
                                            int end, int c0, int cw) {
  const int cc = threadIdx.x % kKT, g = threadIdx.x / kKT;
  if (cc >= cw) return;
  const int col = c0 + cc;
  float x[kNB];
#pragma unroll
  for (int q = 0; q < kNB; ++q) x[q] = q < nbp ? xs[q * xld + cc] : 0.0f;
  if (kUpper) end = min(end, col + 1);
  for (int i0 = first + g; i0 < end; i0 += kGroups * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kGroups;
      v[u] = i < end ? X[i * ldx + col] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kGroups;
      if (i < end) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < kNB; ++q)
          if (q < nbp) s += Ps[q * n + i] * x[q];
        X[i * ldx + col] = v[u] - s;
      }
    }
  }
}

// Step 2 for one panel: solve the panel's kNB pivots in the right-hand side
// X (n x k, row-major, columns [c_begin, c_end)), then update every later
// equation.  Ps[q * n + j] is the coefficient of pivot q of the panel in
// equation j; invd[q] the reciprocal of pivot q's diagonal.  Forward: the
// pivots are rows r0 .. r0 + nbp - 1 and the later equations r0 + nbp .. n - 1;
// backward: the same pivots, solved from the last, and the later equations
// 0 .. r0 - 1.  Xs is a kNB x kKT scratch tile.  Ends with a barrier.
template <bool kForward>
__device__ __forceinline__ void solve_panel(const float* __restrict__ Ps,
                                            const float* __restrict__ invd, int r0, int nbp,
                                            int n, float* __restrict__ X, int k, int c_begin,
                                            int c_end, float* __restrict__ Xs) {
  for (int c0 = c_begin; c0 < c_end; c0 += kKT) {
    const int cw = min(kKT, c_end - c0);
    if (threadIdx.x < cw) {
      const int c = c0 + threadIdx.x;
      float x[kNB];
      if (kForward) {
#pragma unroll
        for (int jj = 0; jj < kNB; ++jj) {
          if (jj < nbp) {
            float s = X[static_cast<long long>(r0 + jj) * k + c];
#pragma unroll
            for (int q = 0; q < jj; ++q) s -= Ps[q * n + r0 + jj] * x[q];
            x[jj] = s * invd[jj];
          }
        }
      } else {
#pragma unroll
        for (int jj = kNB - 1; jj >= 0; --jj) {
          if (jj < nbp) {
            float s = X[static_cast<long long>(r0 + jj) * k + c];
#pragma unroll
            for (int q = jj + 1; q < kNB; ++q)
              if (q < nbp) s -= Ps[q * n + r0 + jj] * x[q];
            x[jj] = s * invd[jj];
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kNB; ++jj) {
        if (jj < nbp) {
          X[static_cast<long long>(r0 + jj) * k + c] = x[jj];
          Xs[jj * kKT + threadIdx.x] = x[jj];
        }
      }
    }
    __syncthreads();
    update_rows<false>(Ps, nbp, n, Xs, kKT, X, k, kForward ? r0 + nbp : 0, kForward ? n : r0,
                       c0, cw);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ B, int n, int k,
                  float* __restrict__ U, float* __restrict__ W, float* __restrict__ logdet,
                  int* __restrict__ info) {
  extern __shared__ float smem[];
  float* P = smem;             // kNB x n: the panel's residual rows
  float* Up = P + kNB * n;     // kNB x n: the panel's factor rows
  float* Xs = Up + kNB * n;    // kNB x kKT
  __shared__ float invd[kNB];

  const long long b = blockIdx.z;
  S += b * n * n;
  U += b * n * n;
  B += b * n * k;
  W += b * n * k;
  const int tid = threadIdx.x;

  // U holds the residual's upper triangle, zero below; W starts as B.
  for (int idx = tid; idx < n * n; idx += blockDim.x)
    U[idx] = (idx % n >= idx / n) ? S[idx] : 0.0f;
  for (int idx = tid; idx < n * k; idx += blockDim.x) W[idx] = B[idx];
  __syncthreads();

  double ld = 0.0;  // thread 0's log-diagonal sum, in row order
  int bad = 0;
  for (int r0 = 0; r0 < n; r0 += kNB) {
    const int nbp = min(kNB, n - r0);
    const int w = n - r0;
    for (int idx = tid; idx < nbp * w; idx += blockDim.x) {
      const int jj = idx / w, l = r0 + idx % w;
      P[jj * n + l] = U[static_cast<long long>(r0 + jj) * n + l];
    }
    __syncthreads();

    // 1. the panel's rows, one pivot at a time
    for (int jj = 0; jj < nbp; ++jj) {
      const int j = r0 + jj;
      const float pivot = P[jj * n + j];
      const float inv = rsqrtf(fmaxf(pivot, kTiny));
      for (int l = j + tid; l < n; l += blockDim.x) Up[jj * n + l] = P[jj * n + l] * inv;
      const int rem = nbp - jj - 1;
      for (int idx = tid; idx < rem * w; idx += blockDim.x) {
        const int ii = jj + 1 + idx / w, l = r0 + idx % w;
        if (l >= r0 + ii) P[ii * n + l] -= (P[jj * n + r0 + ii] * inv) * (P[jj * n + l] * inv);
      }
      if (tid == 0) {
        invd[jj] = inv;
        if (!(pivot > 0.0f) && bad == 0) bad = j + 1;
        ld += log(static_cast<double>(fmaxf(pivot * inv, kTiny)));
      }
      __syncthreads();
    }
    for (int idx = tid; idx < nbp * w; idx += blockDim.x) {
      const int jj = idx / w, l = r0 + idx % w;
      if (l >= r0 + jj) U[static_cast<long long>(r0 + jj) * n + l] = Up[jj * n + l];
    }

    // 2. the panel's rows of W, and every later row
    solve_panel<true>(Up, invd, r0, nbp, n, W, k, 0, k, Xs);

    // 3. rank-nbp update of the trailing matrix's upper triangle
    const int t0 = r0 + nbp;
    for (int c0 = t0; c0 < n; c0 += kKT)
      update_rows<true>(Up, nbp, n, Up + c0, n, U, n, t0, n, c0, min(kKT, n - c0));
    __syncthreads();
  }
  if (tid == 0) {
    logdet[b] = static_cast<float>(2.0 * ld);
    info[b] = bad;
  }
}

template <bool kForward>
__global__ void __launch_bounds__(kThreads)
tri_kernel(const float* __restrict__ U, const float* __restrict__ B, int n, int k,
           float* __restrict__ X) {
  __shared__ float Ps[kNB * kNMax];
  __shared__ float Xs[kNB * kKT];
  __shared__ float invd[kNB];

  const long long b = blockIdx.z;
  U += b * n * n;
  B += b * n * k;
  X += b * n * k;
  const int tid = threadIdx.x;
  const int c_begin = blockIdx.y * kKT, c_end = min(k, c_begin + kKT);
  const int cw = c_end - c_begin;
  for (int idx = tid; idx < n * cw; idx += blockDim.x) {
    const long long e = static_cast<long long>(idx / cw) * k + c_begin + idx % cw;
    X[e] = B[e];
  }
  __syncthreads();

  const int npanels = (n + kNB - 1) / kNB;
  for (int p = 0; p < npanels; ++p) {
    int r0, nbp;
    if (kForward) {
      r0 = p * kNB;
      nbp = min(kNB, n - r0);
      // pivot q is row r0 + q of U; its coefficient in equation j is U[r0 + q, j]
      const int w = n - r0;
      for (int idx = tid; idx < nbp * w; idx += blockDim.x) {
        const int q = idx / w, j = r0 + idx % w;
        Ps[q * n + j] = U[static_cast<long long>(r0 + q) * n + j];
      }
    } else {
      const int end = n - p * kNB;
      r0 = max(0, end - kNB);
      nbp = end - r0;
      // pivot q is column r0 + q of U; its coefficient in equation j is U[j, r0 + q]
      for (int idx = tid; idx < end * nbp; idx += blockDim.x) {
        const int j = idx / nbp, q = idx % nbp;
        Ps[q * n + j] = U[static_cast<long long>(j) * n + r0 + q];
      }
    }
    if (tid < nbp) invd[tid] = 1.0f / U[static_cast<long long>(r0 + tid) * n + r0 + tid];
    __syncthreads();
    solve_panel<kForward>(Ps, invd, r0, nbp, n, X, k, c_begin, c_end, Xs);
  }
}

}  // namespace

extern "C" int dense_chol_solve(const void* S, const void* B, int n, int k, int batch, void* U,
                                void* W, void* logdet, void* info, void* stream) {
  if (n < 1 || n > kNMax || k < 0 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * kNB * n + kNB * kKT);
  cudaError_t e = cudaFuncSetAttribute(chol_solve_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_solve_kernel<<<dim3(1, 1, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(B), n, k,
      static_cast<float*>(U), static_cast<float*>(W), static_cast<float*>(logdet),
      static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}

template <bool kForward>
static int launch_tri(const void* U, const void* B, int n, int k, int batch, void* X,
                      void* stream) {
  if (n < 1 || n > kNMax || k < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(1, (k + kKT - 1) / kKT, batch);
  tri_kernel<kForward><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(U), static_cast<const float*>(B), n, k, static_cast<float*>(X));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_tri_ut(const void* U, const void* B, int n, int k, int batch, void* X,
                            void* stream) {
  return launch_tri<true>(U, B, n, k, batch, X, stream);
}

extern "C" int dense_tri_u(const void* U, const void* B, int n, int k, int batch, void* X,
                           void* stream) {
  return launch_tri<false>(U, B, n, k, batch, X, stream);
}
