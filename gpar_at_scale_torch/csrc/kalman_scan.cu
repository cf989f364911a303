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
// What bounds it: bytes, once the loads are off the dependent chain.  K1
// reads A, Q (2 d^2 floats), R, y per step -- 80 B at d = 3; K2 reads the
// same and writes alpha, log S, K, m, P (2 + 2d + d^2 floats) -- 68 B at
// d = 3: 0.0445 ms at N = 1e6 and 3.35 TB/s, against about 0.01 ms for the
// step's chain of dependent d x d products on one lane per time block.
//
// K1 runs one thread per block and reads its rows straight from device
// memory: a warp's loads are strided by T rows (block-major order), 32
// lines per load instruction, each on the dependent chain.
//
// K2 is staged.  A CUDA block owns kK2Blocks = 32 consecutive time blocks,
// a lane each of its first warp (512 CUDA blocks at 16384 time blocks),
// and walks their steps in chunks of at most kK2Chunk = 8, aligned to the
// series (staging.cuh): inside a time block, chunks meet on 32-byte
// boundaries of every array, so a chunk's stores fill whole sectors where
// the next chunk's would otherwise complete them later (with chunks counted
// back from each block's end, at T = 62 steps, K2 took about 1.5 times as
// long: tools/k2_k4b_step_split.py, "block-anchored").
// For each chunk, each time block's rows of A, Q, R and y are one
// contiguous range per array; all
// four warps copy them into shared memory with 16-byte cp.async,
// neighbouring threads on neighbouring units, double buffered so that the
// next chunk's copies fly while this chunk's steps run (staging.cuh).  The
// three warps beside the one that runs the steps only copy: with one warp
// the copies' address arithmetic, not the bytes, set the pace.  Each lane then reads its
// block's rows from shared memory (slots of whole 16-byte units, so lanes
// 8 apart share a bank: 4-way conflicts on these reads, which stay off
// device memory's latency).  The step's outputs go to shared memory --
// alpha, log S and P in place over y, R and Q, which that step has read;
// K and m into slots of their own -- and the warp stores each chunk's
// ranges with 16-byte stores where whole, again on all four warps.
// Outputs not asked for (NULL) are not stored.  ll and sum log S stay per time block in registers.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "staging.cuh"

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

// K2's stage: kK2Blocks consecutive time blocks per CUDA block, a lane
// each of its first warp, walking their steps in chunks of at most
// kK2Chunk (gpar::window); all
// kK2Threads threads stage and store.  Per block and buffer, a chunk holds
// slots of A and Q (kK2Chunk d^2 floats each) and of R and y (kK2Chunk
// floats each); per block, single-buffered, slots of K and m (kK2Chunk d
// floats each).  The outputs alpha, log S and P are written in place over
// y, R and Q, which their step has read.
constexpr int kK2Blocks = 32;
constexpr int kK2Threads = 128;
constexpr int kK2Chunk = 8;

template <int D>
struct K2Smem {
  static constexpr int SA = gpar::slot_floats(kK2Chunk * D * D);
  static constexpr int SR = gpar::slot_floats(kK2Chunk);
  static constexpr int SK = gpar::slot_floats(kK2Chunk * D);
  static constexpr int kBuf = kK2Blocks * (2 * SA + 2 * SR);  // A, Q, R, y
  static constexpr int kFloats = 2 * kBuf + 2 * kK2Blocks * SK;  // two buffers; K, m
};

// Steps of time block b in [0, T]: 0 past n and past the last block.
__device__ __forceinline__ int block_len(long long b, long long T, long long n, int nblocks) {
  return b < nblocks ? static_cast<int>(max(0LL, min(T, n - b * T))) : 0;
}

template <int D>
__global__ void __launch_bounds__(kK2Threads)
phase3_kernel(const float* __restrict__ A, const float* __restrict__ Q,
              const float* __restrict__ R, const float* __restrict__ y, long long n, long long T,
              int nblocks, const float* __restrict__ m0, const float* __restrict__ P0,
              float* __restrict__ alpha, float* __restrict__ logs, float* __restrict__ K_out,
              float* __restrict__ m_out, float* __restrict__ P_out, float* __restrict__ ll_blk,
              float* __restrict__ ls_blk) {
  using L = K2Smem<D>;
  constexpr int CH = kK2Chunk, DD = D * D, NB = kK2Blocks, NT = kK2Threads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sK = smem + 2 * L::kBuf;  // [NB][SK]
  float* sm = sK + NB * L::SK;     // [NB][SK]
  __shared__ int s_len[NB], s_org[NB];  // steps and chunk origin of each time block
  __shared__ int s_nch;  // chunks of the CUDA block: the most of any time block

  const int tid = threadIdx.x, lane = tid;
  const long long b0 = static_cast<long long>(blockIdx.x) * NB;
  const long long blk = b0 + lane;  // the time block of lane `lane` of warp 0
  const int len = tid < NB ? block_len(blk, T, n, nblocks) : 0;
  const int org = gpar::window_origin<CH>(blk * T, len, true);
  if (tid < NB) {  // warp 0
    s_len[tid] = len;
    s_org[tid] = org;
    const int most = __reduce_max_sync(0xffffffffu, gpar::windows<CH>(org, len));
    if (tid == 0) s_nch = most;
  }
  __syncthreads();
  const int nch = s_nch;

  // Buffer ch & 1 of chunk ch: [A: NB][SA], [Q: NB][SA], [R: NB][SR], [y: NB][SR].
  auto sA = [&](int ch) { return smem + (ch & 1) * L::kBuf; };
  auto sQ = [&](int ch) { return sA(ch) + NB * L::SA; };
  auto sR = [&](int ch) { return sA(ch) + 2 * NB * L::SA; };
  auto sy = [&](int ch) { return sR(ch) + NB * L::SR; };

  // Chunk ch of time block b0 + j: its rows and its first step.
  auto rows_of = [&](int j, int ch, long long& k0) {
    int lo;
    const int rows = gpar::window<CH>(s_org[j], s_len[j], ch, lo);
    k0 = (b0 + j) * T + lo;
    return rows;
  };

  auto stage = [&](int ch) {
    auto chunk = [&](int j, long long& k0) { return rows_of(j, ch, k0); };
    gpar::ranges_in<DD, L::SA>(sA(ch), A, n, NB, chunk, tid, NT);
    gpar::ranges_in<DD, L::SA>(sQ(ch), Q, n, NB, chunk, tid, NT);
    gpar::ranges_in<1, L::SR>(sR(ch), R, n, NB, chunk, tid, NT);
    gpar::ranges_in<1, L::SR>(sy(ch), y, n, NB, chunk, tid, NT);
    __pipeline_commit();
  };

  auto store = [&](int ch) {
    auto chunk = [&](int j, long long& k0) { return rows_of(j, ch, k0); };
    gpar::ranges_out<1, L::SR>(alpha, sy(ch), NB, chunk, tid, NT);
    gpar::ranges_out<1, L::SR>(logs, sR(ch), NB, chunk, tid, NT);
    if (K_out != nullptr) gpar::ranges_out<D, L::SK>(K_out, sK, NB, chunk, tid, NT);
    if (m_out != nullptr) {
      gpar::ranges_out<D, L::SK>(m_out, sm, NB, chunk, tid, NT);
      gpar::ranges_out<DD, L::SA>(P_out, sQ(ch), NB, chunk, tid, NT);
    }
  };

  float m[D], P[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m[i] = len > 0 ? m0[blk * D + i] : 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) P[i][j] = len > 0 ? P0[(blk * D + i) * D + j] : 0.0f;
  }
  float ll = 0.0f, ls = 0.0f;

  if (nch > 0) stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    int lo;
    const int rows = gpar::window<CH>(org, len, ch, lo);  // none on the helper warps
    const long long k0 = blk * T + lo;
    const float* a = sA(ch) + lane * L::SA + gpar::lead(k0 * DD);
    float* q = sQ(ch) + lane * L::SA + gpar::lead(k0 * DD);  // Q in, P out
    float* rr = sR(ch) + lane * L::SR + gpar::lead(k0);       // R in, log S out
    float* yy = sy(ch) + lane * L::SR + gpar::lead(k0);       // y in, alpha out
    float* kk = sK + lane * L::SK + gpar::lead(k0 * D);
    float* mm = sm + lane * L::SK + gpar::lead(k0 * D);
    for (int t = 0; t < rows; ++t) {
      float Ak[D][D], Pp[D][D], AP[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) Ak[i][j] = a[t * DD + i * D + j];
      const float Rk = rr[t];
      const float yk = yy[t];

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
          float s = q[t * DD + i * D + j];
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
      const float al = v / sqrtf(S);
      ll += -0.5f * (kLog2Pi + logS + al * al);
      ls += logS;
      // [K2 outputs]
      yy[t] = al;
      rr[t] = logS;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        kk[t * D + i] = K[i];
        mm[t * D + i] = m[i];
#pragma unroll
        for (int j = 0; j < D; ++j) q[t * DD + i * D + j] = P[i][j];
      }
      // [end K2 outputs]
    }
    __syncthreads();
    store(ch);
    __syncthreads();
  }
  if (tid < NB && blk < nblocks) {
    ll_blk[blk] = ll;
    ls_blk[blk] = ls;
  }
}

// K1: 64 threads per CUDA block, one time block each: at the main path's
// 16384 time blocks that is 256 CUDA blocks, enough to put work on every
// one of the 132 SMs.
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
  if (n < 1 || T < 1 || nblocks < 1 || static_cast<long long>(nblocks) * T < n ||
      (m_out == nullptr) != (P_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!gpar::aligned16({A, Q, R, y, alpha, logs, K_out, m_out, P_out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((nblocks + kK2Blocks - 1) / kK2Blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_P3(DD)                                                                          \
  {                                                                                          \
    const int smem = static_cast<int>(sizeof(float)) * K2Smem<DD>::kFloats;                  \
    const cudaError_t e = cudaFuncSetAttribute(                                              \
        phase3_kernel<DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
    if (e != cudaSuccess) return static_cast<int>(e);                                        \
    phase3_kernel<DD><<<grid, kK2Threads, smem, s>>>(                                         \
        static_cast<const float*>(A), static_cast<const float*>(Q),                          \
        static_cast<const float*>(R), static_cast<const float*>(y), n, T, nblocks,           \
        static_cast<const float*>(m0), static_cast<const float*>(P0),                        \
        static_cast<float*>(alpha), static_cast<float*>(logs), static_cast<float*>(K_out),   \
        static_cast<float*>(m_out), static_cast<float*>(P_out),                              \
        static_cast<float*>(ll_blk), static_cast<float*>(ls_blk));                           \
  }
  switch (d) {
    case 1: GPAR_P3(1); break;
    case 2: GPAR_P3(2); break;
    case 3: GPAR_P3(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_P3
  return static_cast<int>(cudaGetLastError());
}
