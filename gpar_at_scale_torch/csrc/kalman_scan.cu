// Blocked-scan Kalman filter: phase 1 (K1) and phase 3 (K2) for Hopper.
//
// Replaces the TPU kernels gpar_at_scale_tpu/ops/pallas_kalman.py::
// _phase1_kernel (K1) and ::_phase3_kernel (K2).  The series of n steps is
// split into nblocks contiguous blocks of T steps; block b owns steps
// [b*T, min((b+1)*T, n)).  One lane runs one block with the whole d x d
// state (d templated over 1..3, H = e1) unrolled in registers.
//
//   K1: reduces the block to its Sarkka & Garcia-Fernandez filtering
//       element (A, b, C, eta, J): the filter run through the block
//       conditioned on the state x entering it, filtered mean A x + b and
//       covariance C, and the information (eta, J) the block's
//       observations carry on x.  It is the fold of the block's one-step
//       elements, computed without the combine's inverses (below).
//   K2: replays the block from its filtered init (m0, P0) -- the exclusive
//       prefix of the block elements, computed between the launches -- with
//       the plain Kalman recursion in Joseph form, and emits per step
//       alpha = v / sqrt(S), log S and optionally K, m, P, plus per block
//       the log-likelihood and sum log S.
//
// Steps at or past n do not exist here: a block stops at n.  That is the
// JAX kernels' padding convention (mask 0 leaves the running element and
// the state unchanged and adds nothing to ll) without padded inputs: a
// block of padding only emits the identity element.
//
// What bounds it: bytes, once the loads are off the dependent chain.  K1
// reads A, Q (2 d^2 floats), R, y per step -- 80 B at d = 3 -- and writes
// 3 d^2 + 2 d = 33 floats per time block: 0.0245 ms at N = 1e6 and 3.35 TB/s;
// K2 reads the same and writes alpha, log S, K, m, P (2 + 2d + d^2 floats)
// -- 68 B at d = 3: 0.0445 ms.
//
// K1's step.  Folding one-step elements with the general combine costs two
// d x d inverses and 767 floating-point operations a step at d = 3 (an
// FMA counts two).  Since the running element starts at the identity
// (I, 0, 0, 0, 0) and each step has H = e1, the fold is the affine filter
// conditioned on x, step k:
//   Ab = A_k A_r   bb = A_k b_r   Cb = A_k C_r A_k^T + Q_k
//   S = Cb[0][0] + R_k   K = Cb[:, 0] / S   h = Ab[0, :]   v = y_k - bb[0]
//   J_r += h^T h / S     eta_r += h^T v / S
//   A_r = Ab - K h       b_r = bb + K v     C_r = Cb - K Cb[0, :]
// -- the same element in exact arithmetic, 225 operations and one
// reciprocal a step at d = 3, C and J kept symmetric by computing their
// upper triangles.  With y = 0 (the gain pass) b and eta stay exactly 0.
//
// Both kernels are staged.  A CUDA block owns 32 consecutive time blocks,
// a lane each of its first warp (512 CUDA blocks at 16384 time blocks),
// and walks their steps in chunks of at most 8, aligned to the series
// (staging.cuh): inside a time block, chunks meet on 32-byte
// boundaries of every array, so a chunk's stores fill whole sectors where
// the next chunk's would otherwise complete them later (with chunks counted
// back from each block's end, at T = 62 steps, K2 took about 1.5 times as
// long: tools/k2_k4b_step_split.py, "block-anchored").
// For each chunk, each time block's rows of A, Q, R and y are one
// contiguous range per array; every warp of the CUDA block (K1: 8, K2: 4)
// copies them into shared memory with 16-byte cp.async,
// neighbouring threads on neighbouring units, double buffered so that the
// next chunk's copies fly while this chunk's steps run (staging.cuh).  The
// warps beside the one that runs the steps only copy: with one warp
// the copies' address arithmetic, not the bytes, set the pace (K1 with 1,
// 3 and 7 copy warps: tools/k1_step_split.py).  Each lane then reads its
// block's rows from shared memory (slots of whole 16-byte units, so lanes
// 8 apart share a bank: 4-way conflicts on these reads, which stay off
// device memory's latency).  K1 stores only its block element, 33 floats
// per time block at the end, through shared memory as 16-byte units.  K2's
// step outputs go to shared memory --
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

// Steps of time block b in [0, T]: 0 past n and past the last block.
__device__ __forceinline__ int block_len(long long b, long long T, long long n, int nblocks) {
  return b < nblocks ? static_cast<int>(max(0LL, min(T, n - b * T))) : 0;
}

// K1's stage: kK1Blocks consecutive time blocks per CUDA block, a lane
// each of its first warp, walking their steps in chunks of at most
// kK1Chunk (gpar::window, aligned to the series); all kK1Threads threads
// stage and store.  Per block and buffer, a chunk holds slots of A and Q
// (kK1Chunk d^2 floats each) and of R and y (kK1Chunk floats each).
constexpr int kK1Blocks = 32;
constexpr int kK1Threads = 256;
constexpr int kK1Chunk = 8;

template <int D>
struct K1Smem {
  static constexpr int SA = gpar::slot_floats(kK1Chunk * D * D);
  static constexpr int SR = gpar::slot_floats(kK1Chunk);
  static constexpr int kBuf = kK1Blocks * (2 * SA + 2 * SR);  // A, Q, R, y
  static constexpr int kFloats = 2 * kBuf;                     // two buffers
};

template <int D>
__global__ void __launch_bounds__(kK1Threads)
phase1_kernel(const float* __restrict__ A, const float* __restrict__ Q,
              const float* __restrict__ R, const float* __restrict__ y, long long n, long long T,
              int nblocks, float* __restrict__ eA, float* __restrict__ eb,
              float* __restrict__ eC, float* __restrict__ eeta, float* __restrict__ eJ) {
  using L = K1Smem<D>;
  constexpr int CH = kK1Chunk, DD = D * D, NB = kK1Blocks, NT = kK1Threads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_len[NB], s_org[NB];  // steps and chunk origin of each time block
  __shared__ int s_nch;  // chunks of the CUDA block: the most of any time block

  const int tid = threadIdx.x, lane = tid;
  const long long b0 = static_cast<long long>(blockIdx.x) * NB;
  const long long blk = b0 + lane;  // the time block of lane `lane` of warp 0
  const int len = tid < NB ? block_len(blk, T, n, nblocks) : 0;
  const int org = gpar::window_origin<CH>(blk * T, len, /*aligned=*/true);
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

  auto stage = [&](int ch) {
    auto chunk = [&](int j, long long& k0) {  // chunk ch of time block b0 + j
      int lo;
      const int rows = gpar::window<CH>(s_org[j], s_len[j], ch, lo);
      k0 = (b0 + j) * T + lo;
      return rows;
    };
    gpar::ranges_in<DD, L::SA>(sA(ch), A, n, NB, chunk, tid, NT);
    gpar::ranges_in<DD, L::SA>(sQ(ch), Q, n, NB, chunk, tid, NT);
    gpar::ranges_in<1, L::SR>(sR(ch), R, n, NB, chunk, tid, NT);
    gpar::ranges_in<1, L::SR>(sy(ch), y, n, NB, chunk, tid, NT);
    __pipeline_commit();
  };

  // The running element, from the identity (I, 0, 0, 0, 0).
  float Ar[D][D], br[D], Cr[D][D], er[D], Jr[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    br[i] = 0.0f;
    er[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      Ar[i][j] = (i == j) ? 1.0f : 0.0f;
      Cr[i][j] = 0.0f;
      Jr[i][j] = 0.0f;
    }
  }

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
    const float* q = sQ(ch) + lane * L::SA + gpar::lead(k0 * DD);
    const float* rr = sR(ch) + lane * L::SR + gpar::lead(k0);
    const float* yy = sy(ch) + lane * L::SR + gpar::lead(k0);
    for (int t = 0; t < rows; ++t) {
      // [K1 step]
      float Ak[D][D], Ab[D][D], AC[D][D], Cb[D][D], bb[D];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) Ak[i][j] = a[t * DD + i * D + j];
      matmul<D>(Ak, Ar, Ab);
      matmul<D>(Ak, Cr, AC);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) s += Ak[i][l] * br[l];
        bb[i] = s;
#pragma unroll
        for (int j = i; j < D; ++j) {  // Cb = A_k C_r A_k^T + Q_k, upper triangle
          float c = q[t * DD + i * D + j];
#pragma unroll
          for (int l = 0; l < D; ++l) c += AC[i][l] * Ak[j][l];
          Cb[i][j] = c;
          Cb[j][i] = c;
        }
      }
      const float inv_s = 1.0f / (Cb[0][0] + rr[t]);
      const float v = yy[t] - bb[0];
      float K[D], hs[D];  // K = Cb[:, 0] / S, hs = h / S with h = Ab[0, :]
#pragma unroll
      for (int i = 0; i < D; ++i) {
        K[i] = Cb[i][0] * inv_s;
        hs[i] = Ab[0][i] * inv_s;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        er[i] += hs[i] * v;
        br[i] = bb[i] + K[i] * v;
#pragma unroll
        for (int j = i; j < D; ++j) {
          Jr[i][j] += hs[i] * Ab[0][j];
          Jr[j][i] = Jr[i][j];
          Cr[i][j] = Cb[i][j] - K[i] * Cb[0][j];
          Cr[j][i] = Cr[i][j];
        }
#pragma unroll
        for (int j = 0; j < D; ++j) Ar[i][j] = Ab[i][j] - K[i] * Ab[0][j];
      }
      // [end K1 step]
    }
    __syncthreads();
  }
  // [K1 stores] The element of each time block out through shared memory
  // (the stage's first buffer, which every lane has read): per output,
  // the CUDA block's time blocks are one contiguous range from a 16-byte
  // boundary, stored as 16-byte units by every warp.
  float* sEA = smem;           // [NB][D][D]
  float* sEb = sEA + NB * DD;  // [NB][D]
  float* sEC = sEb + NB * D;   // [NB][D][D]
  float* sEe = sEC + NB * DD;  // [NB][D]
  float* sEJ = sEe + NB * D;   // [NB][D][D]
  if (tid < NB) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      sEb[lane * D + i] = br[i];
      sEe[lane * D + i] = er[i];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        sEA[lane * DD + i * D + j] = Ar[i][j];
        sEC[lane * DD + i * D + j] = Cr[i][j];
        sEJ[lane * DD + i * D + j] = Jr[i][j];
      }
    }
  }
  __syncthreads();
  auto mine = [&](int, long long& k0) {  // this CUDA block's time blocks
    k0 = b0;
    return static_cast<int>(min(static_cast<long long>(NB), nblocks - b0));
  };
  gpar::ranges_out<DD, NB * DD>(eA, sEA, 1, mine, tid, NT);
  gpar::ranges_out<D, NB * D>(eb, sEb, 1, mine, tid, NT);
  gpar::ranges_out<DD, NB * DD>(eC, sEC, 1, mine, tid, NT);
  gpar::ranges_out<D, NB * D>(eeta, sEe, 1, mine, tid, NT);
  gpar::ranges_out<DD, NB * DD>(eJ, sEJ, 1, mine, tid, NT);
  // [end K1 stores]
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

}  // namespace

extern "C" int kalman_phase1(int d, const void* A, const void* Q, const void* R, const void* y,
                             long long n, long long T, int nblocks, void* eA, void* eb, void* eC,
                             void* eeta, void* eJ, void* stream) {
  if (n < 1 || T < 1 || nblocks < 1 || static_cast<long long>(nblocks) * T < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!gpar::aligned16({A, Q, R, y, eA, eb, eC, eeta, eJ}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((nblocks + kK1Blocks - 1) / kK1Blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_P1(DD)                                                                          \
  {                                                                                          \
    const int smem = static_cast<int>(sizeof(float)) * K1Smem<DD>::kFloats;                  \
    const cudaError_t e = cudaFuncSetAttribute(                                              \
        phase1_kernel<DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
    if (e != cudaSuccess) return static_cast<int>(e);                                        \
    phase1_kernel<DD><<<grid, kK1Threads, smem, s>>>(                                         \
        static_cast<const float*>(A), static_cast<const float*>(Q),                          \
        static_cast<const float*>(R), static_cast<const float*>(y), n, T, nblocks,           \
        static_cast<float*>(eA), static_cast<float*>(eb), static_cast<float*>(eC),           \
        static_cast<float*>(eeta), static_cast<float*>(eJ));                                 \
  }
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
