// Blocked-scan Kalman filter: phase 1 (K1) and phase 3 (K2) for Hopper.
//
// Replaces the TPU kernels gpar_at_scale_tpu/ops/pallas_kalman.py::
// _phase1_kernel (K1) and ::_phase3_kernel (K2).  The series of n steps is
// split into nblocks contiguous blocks of T steps; block b owns steps
// [b*T, min((b+1)*T, n)).  One thread runs one block with the whole d x d
// state (d templated over 1..3, H = e1) unrolled in registers.
//
//   K1: folds the block's Sarkka & Garcia-Fernandez filtering elements
//       (A, b, C, eta, J) into one block element.
//   K2: replays the block from its filtered init (m0, P0) -- the exclusive
//       prefix of the block elements, computed between the launches -- with
//       the plain Kalman recursion in Joseph form, and emits per step
//       alpha = v / sqrt(S), log S and optionally K, m, P, plus per block
//       the log-likelihood and sum log S.
//
// Steps at or past n do not exist here: a block stops at n.  That is the
// JAX kernels' padding convention (mask 0 leaves the running element and
// the state unchanged and adds nothing to ll) without padded inputs.
//
// What bounds it: each step is a chain of dependent d x d products (K1
// also two adjugate inverses), so a block is latency-bound; the card hides
// that latency only with many blocks in flight, which is why the wrapper
// picks thousands of blocks (ssm/blocked.py).  Bytes per step: K1 reads
// A, Q (2 d^2 floats), R, y -- 80 B at d = 3; K2 reads the same and writes
// alpha, log S, K, m, P (2 + 2d + d^2 floats) -- 68 B at d = 3.  Each
// thread reads its own contiguous rows, so a warp's loads are strided by
// T rows (block-major order); the L1 lines each thread fetches serve its
// next steps.  A step-major layout, coalesced across threads, is later
// performance work.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;

template <int D>
struct Elem {
  float A[D][D];
  float b[D];
  float C[D][D];
  float eta[D];
  float J[D][D];
};

template <int D>
__device__ __forceinline__ void inv_small(const float Z[D][D], float out[D][D]) {
  if constexpr (D == 1) {
    out[0][0] = 1.0f / Z[0][0];
  } else if constexpr (D == 2) {
    float inv_det = 1.0f / (Z[0][0] * Z[1][1] - Z[0][1] * Z[1][0]);
    out[0][0] = Z[1][1] * inv_det;
    out[0][1] = -Z[0][1] * inv_det;
    out[1][0] = -Z[1][0] * inv_det;
    out[1][1] = Z[0][0] * inv_det;
  } else {
    float c00 = Z[1][1] * Z[2][2] - Z[1][2] * Z[2][1];
    float c01 = Z[1][2] * Z[2][0] - Z[1][0] * Z[2][2];
    float c02 = Z[1][0] * Z[2][1] - Z[1][1] * Z[2][0];
    float inv_det = 1.0f / (Z[0][0] * c00 + Z[0][1] * c01 + Z[0][2] * c02);
    float c10 = Z[0][2] * Z[2][1] - Z[0][1] * Z[2][2];
    float c11 = Z[0][0] * Z[2][2] - Z[0][2] * Z[2][0];
    float c12 = Z[0][1] * Z[2][0] - Z[0][0] * Z[2][1];
    float c20 = Z[0][1] * Z[1][2] - Z[0][2] * Z[1][1];
    float c21 = Z[0][2] * Z[1][0] - Z[0][0] * Z[1][2];
    float c22 = Z[0][0] * Z[1][1] - Z[0][1] * Z[1][0];
    out[0][0] = c00 * inv_det; out[0][1] = c10 * inv_det; out[0][2] = c20 * inv_det;
    out[1][0] = c01 * inv_det; out[1][1] = c11 * inv_det; out[1][2] = c21 * inv_det;
    out[2][0] = c02 * inv_det; out[2][1] = c12 * inv_det; out[2][2] = c22 * inv_det;
  }
}

template <int D>
__device__ __forceinline__ void matmul(const float X[D][D], const float Y[D][D], float out[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) s += X[i][k] * Y[k][j];
      out[i][j] = s;
    }
}

// r <- r o e  (r earlier, e later): the filtering-element combine.
template <int D>
__device__ __forceinline__ void combine(Elem<D>& r, const Elem<D>& e) {
  float Z[D][D], Zi[D][D], AjZ[D][D], A_new[D][D], T1[D][D];
  matmul<D>(r.C, e.J, Z);
#pragma unroll
  for (int i = 0; i < D; ++i) Z[i][i] += 1.0f;
  inv_small<D>(Z, Zi);
  matmul<D>(e.A, Zi, AjZ);
  matmul<D>(AjZ, r.A, A_new);

  float tmp[D], b_new[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = r.b[i];
#pragma unroll
    for (int k = 0; k < D; ++k) s += r.C[i][k] * e.eta[k];
    tmp[i] = s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = e.b[i];
#pragma unroll
    for (int k = 0; k < D; ++k) s += AjZ[i][k] * tmp[k];
    b_new[i] = s;
  }

  float C_new[D][D];
  matmul<D>(AjZ, r.C, T1);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = e.C[i][j];
#pragma unroll
      for (int k = 0; k < D; ++k) s += T1[i][k] * e.A[j][k];
      C_new[i][j] = s;
    }

  float Z2[D][D], Z2i[D][D], AiTZ2[D][D];
  matmul<D>(e.J, r.C, Z2);
#pragma unroll
  for (int i = 0; i < D; ++i) Z2[i][i] += 1.0f;
  inv_small<D>(Z2, Z2i);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) s += r.A[k][i] * Z2i[k][j];
      AiTZ2[i][j] = s;
    }

  float eta_new[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = e.eta[i];
#pragma unroll
    for (int k = 0; k < D; ++k) s -= e.J[i][k] * r.b[k];
    tmp[i] = s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = r.eta[i];
#pragma unroll
    for (int k = 0; k < D; ++k) s += AiTZ2[i][k] * tmp[k];
    eta_new[i] = s;
  }

  float J_new[D][D];
  matmul<D>(AiTZ2, e.J, T1);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = r.J[i][j];
#pragma unroll
      for (int k = 0; k < D; ++k) s += T1[i][k] * r.A[k][j];
      J_new[i][j] = s;
    }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    r.b[i] = b_new[i];
    r.eta[i] = eta_new[i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      r.A[i][j] = A_new[i][j];
      r.C[i][j] = C_new[i][j];
      r.J[i][j] = J_new[i][j];
    }
  }
}

template <int D>
__global__ void phase1_kernel(const float* __restrict__ A, const float* __restrict__ Q,
                              const float* __restrict__ R, const float* __restrict__ y,
                              long long n, long long T, int nblocks,
                              float* __restrict__ eA, float* __restrict__ eb,
                              float* __restrict__ eC, float* __restrict__ eeta,
                              float* __restrict__ eJ) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= nblocks) return;

  Elem<D> r;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    r.b[i] = 0.0f;
    r.eta[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      r.A[i][j] = (i == j) ? 1.0f : 0.0f;
      r.C[i][j] = 0.0f;
      r.J[i][j] = 0.0f;
    }
  }

  const long long start = (long long)blk * T;
  const long long stop = min(start + T, n);
  for (long long k = start; k < stop; ++k) {
    float Ak[D][D], Qk[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        Ak[i][j] = A[k * D * D + i * D + j];
        Qk[i][j] = Q[k * D * D + i * D + j];
      }
    const float yk = y[k];
    // S = H Q H^T + R = Q[0][0] + R; K = Q[:, 0] / S   (H = e1)
    const float S = Qk[0][0] + R[k];
    float K[D];
#pragma unroll
    for (int i = 0; i < D; ++i) K[i] = Qk[i][0] / S;

    Elem<D> e;
    const float y_over_S = yk / S;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      e.b[i] = K[i] * yk;
      e.eta[i] = Ak[0][i] * y_over_S;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        e.A[i][j] = Ak[i][j] - K[i] * Ak[0][j];
        e.C[i][j] = Qk[i][j] - K[i] * Qk[0][j];
        e.J[i][j] = Ak[0][i] * Ak[0][j] / S;
      }
    }
    combine<D>(r, e);
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    eb[blk * D + i] = r.b[i];
    eeta[blk * D + i] = r.eta[i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      eA[blk * D * D + i * D + j] = r.A[i][j];
      eC[blk * D * D + i * D + j] = r.C[i][j];
      eJ[blk * D * D + i * D + j] = r.J[i][j];
    }
  }
}

template <int D>
__global__ void phase3_kernel(const float* __restrict__ A, const float* __restrict__ Q,
                              const float* __restrict__ R, const float* __restrict__ y,
                              long long n, long long T, int nblocks,
                              const float* __restrict__ m0, const float* __restrict__ P0,
                              float* __restrict__ alpha, float* __restrict__ logs,
                              float* __restrict__ K_out, float* __restrict__ m_out,
                              float* __restrict__ P_out, float* __restrict__ ll_blk,
                              float* __restrict__ ls_blk) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= nblocks) return;

  float m[D], P[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m[i] = m0[blk * D + i];
#pragma unroll
    for (int j = 0; j < D; ++j) P[i][j] = P0[blk * D * D + i * D + j];
  }
  float ll = 0.0f, ls = 0.0f;

  const long long start = (long long)blk * T;
  const long long stop = min(start + T, n);
  for (long long k = start; k < stop; ++k) {
    float Ak[D][D], Pp[D][D], AP[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) Ak[i][j] = A[k * D * D + i * D + j];
    const float Rk = R[k];
    const float yk = y[k];

    float mp[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += Ak[i][j] * m[j];
      mp[i] = s;
    }
    matmul<D>(Ak, P, AP);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = Q[k * D * D + i * D + j];
#pragma unroll
        for (int l = 0; l < D; ++l) s += AP[i][l] * Ak[j][l];
        Pp[i][j] = s;
      }

    const float S = Pp[0][0] + Rk;
    const float v = yk - mp[0];
    float K[D];
#pragma unroll
    for (int i = 0; i < D; ++i) K[i] = Pp[i][0] / S;

    // Joseph form: P = (I - K H) Pp (I - K H)^T + R K K^T   (H = e1)
    float IKP[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) IKP[i][j] = Pp[i][j] - K[i] * Pp[0][j];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m[i] = mp[i] + K[i] * v;
#pragma unroll
      for (int j = 0; j < D; ++j) P[i][j] = IKP[i][j] - IKP[i][0] * K[j] + Rk * K[i] * K[j];
    }

    const float logS = logf(S);
    const float a = v / sqrtf(S);
    alpha[k] = a;
    logs[k] = logS;
    ll += -0.5f * (kLog2Pi + logS + a * a);
    ls += logS;
    if (K_out != nullptr) {
#pragma unroll
      for (int i = 0; i < D; ++i) K_out[k * D + i] = K[i];
    }
    if (m_out != nullptr) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        m_out[k * D + i] = m[i];
#pragma unroll
        for (int j = 0; j < D; ++j) P_out[k * D * D + i * D + j] = P[i][j];
      }
    }
  }
  ll_blk[blk] = ll;
  ls_blk[blk] = ls;
}

// 64 threads per CUDA block: at the main path's 16384 time blocks that is
// 256 CUDA blocks, enough to put work on every one of the 132 SMs.
constexpr int kThreads = 64;

}  // namespace

extern "C" int kalman_phase1(int d, const void* A, const void* Q, const void* R, const void* y,
                             long long n, long long T, int nblocks, void* eA, void* eb, void* eC,
                             void* eeta, void* eJ, void* stream) {
  const dim3 grid((nblocks + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_P1(DD)                                                                          \
  phase1_kernel<DD><<<grid, kThreads, 0, s>>>(                                               \
      static_cast<const float*>(A), static_cast<const float*>(Q),                            \
      static_cast<const float*>(R), static_cast<const float*>(y), n, T, nblocks,             \
      static_cast<float*>(eA), static_cast<float*>(eb), static_cast<float*>(eC),             \
      static_cast<float*>(eeta), static_cast<float*>(eJ))
  switch (d) {
    case 1: GPAR_P1(1); break;
    case 2: GPAR_P1(2); break;
    case 3: GPAR_P1(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_P1
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kalman_phase3(int d, const void* A, const void* Q, const void* R, const void* y,
                             long long n, long long T, int nblocks, const void* m0,
                             const void* P0, void* alpha, void* logs, void* K_out, void* m_out,
                             void* P_out, void* ll_blk, void* ls_blk, void* stream) {
  const dim3 grid((nblocks + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_P3(DD)                                                                          \
  phase3_kernel<DD><<<grid, kThreads, 0, s>>>(                                               \
      static_cast<const float*>(A), static_cast<const float*>(Q),                            \
      static_cast<const float*>(R), static_cast<const float*>(y), n, T, nblocks,             \
      static_cast<const float*>(m0), static_cast<const float*>(P0),                          \
      static_cast<float*>(alpha), static_cast<float*>(logs), static_cast<float*>(K_out),     \
      static_cast<float*>(m_out), static_cast<float*>(P_out), static_cast<float*>(ll_blk),   \
      static_cast<float*>(ls_blk))
  switch (d) {
    case 1: GPAR_P3(1); break;
    case 2: GPAR_P3(2); break;
    case 3: GPAR_P3(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_P3
  return static_cast<int>(cudaGetLastError());
}
