// The adjoint's elements (K5a) and scores (K5b) of the whitened-Gram
// backward on Hopper.
//
// No pallas_call is replaced: the JAX package's K5 (gpar_at_scale_tpu/ops/
// pallas_grad.py) is a custom VJP whose elementwise glue around the suffix
// scan XLA fuses by itself.  The port's tensor code for the same algebra
// (ssm/blocked_grad.py::whiten_bwd_elements, ::whiten_bwd_scores, their
// plain versions) ran it as batched 3 x 3 cuBLAS products, gemvs, shifted
// copies and a dozen elementwise passes; these two kernels do it in one pass
// each.  With per-step innovations e_k (B columns), their variances S_k,
// gains K_k, filtered moments (m_k (d, B), P_k), transitions A_k and H = e1:
//
//   K5a: C_k = (A_{k+1} (I - K_k e1^T))^T   (A_n = 0 after the last step),
//        b_k = e1 (x) e_k / S_k  (d, B),   W_k = e1 e1^T / S_k,
//        the suffix-scan elements of the adjoint recursions (K4a/K4b);
//   K5b: from the scanned adjoints r (n, d, B) and N (n, d, d), a symmetric
//        ctsym (B, B) and a scalar ct_ld,
//          AP = A_k P_{k-1},  AK = A_{k+1} K_k,
//          u  = e_k / S_k - AK^T r_{k+1},   D = 1 / S_k + AK^T N_{k+1} AK,
//          R2 = r_k ctsym r_k^T,   Rm = r_k ctsym m_{k-1}^T,
//          ct_A = -2 (R2 AP + Rm) + 2 ct_ld N_k AP,   ct_Q = -R2 + ct_ld N_k,
//          ct_R = -u ctsym u^T + ct_ld D,             ct_U = 2 u ctsym,
//        with the rows after the last step and before the first zero.
//
// What bounds them: bytes.  At d = 3, B = 33 K5a reads 184 and writes 468
// bytes a step, K5b reads 1,048 (A, P, K, S, e, m, r, N) and writes 208,
// against about 9 kFLOP a step of K5b's products with ctsym -- at 10^7
// steps 1.95 and 3.75 ms of bytes, 1.3 ms of float32 arithmetic.  So each
// array is read once, coalesced, and nothing between the inputs and the
// outputs goes back to device memory:
//
//   K5a: a CUDA block owns 128 steps, a thread each for C and W (staged in
//        shared memory, stored as 16-byte units); b's range of the block is
//        written by all threads in 16-byte units, e read once.
//   K5b: a CUDA block owns a tile of TS consecutive steps (32 at B = 33,
//        fewer at wide B so that three blocks fit an SM) and stages the
//        tile's contiguous ranges of every input with 16-byte cp.async, in
//        two groups: r (with the step after the tile), e, A, K, S and ctsym
//        (where it fits; wide B reads it through L1/L2) first, then m and
//        P (with the step before the tile) and N, which land while the
//        first products run.  Thread (s, g) is on step s of the tile and
//        takes the passes g, g + G, ... of 12 columns (8 where B <= 8): it
//        forms u in place over e, then a pass's products [r_k; u] ctsym in
//        registers (ctsym's rows are broadcast 16-byte loads), and folds
//        them at once into its partial R2, Rm and u ctsym u^T and its
//        columns of ct_U.  Group 0 sums the groups' partials in a fixed
//        order and forms ct_A, ct_Q and ct_R.  At B = 33 that is 3 warps,
//        one pass each, and 5 blocks an SM.  No cat copy, no rc, R2 or Rm
//        array exists.  (Tried on the card and dropped: one warp a block
//        with all 36 columns in registers, 255 registers and 6 warps an SM;
//        4-column chunks over 4 warps; a persistent grid double-buffering
//        its tiles, which halves the blocks an SM -- each slower.)
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry
// returns cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 128;    // K5a
constexpr int kElemSteps = 128;  // K5a: steps per CUDA block, one a thread
constexpr int kScoreSteps = 32;  // K5b: most steps per CUDA block
constexpr int kSmemTarget = 64 * 1024;  // K5b: at least three blocks an SM
constexpr int kSmemMax = 232448;        // a block's most shared memory on Hopper

using gpar::stage_range;
using gpar::store_range;

template <int D>
__global__ void __launch_bounds__(kThreads)
adjoint_elements_kernel(const float* __restrict__ A, const float* __restrict__ K,
                        const float* __restrict__ S, const float* __restrict__ e, long long n,
                        int B, float* __restrict__ C_out, float* __restrict__ b_out,
                        float* __restrict__ W_out) {
  constexpr int DD = D * D, TS = kElemSteps, SLOT = gpar::slot_floats(TS * DD);
  __shared__ float4 smem4[(2 * SLOT + TS) / 4];
  float* sC = reinterpret_cast<float*>(smem4);
  float* sW = sC + SLOT;
  float* sS = sW + SLOT;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long k0 = static_cast<long long>(blockIdx.x) * TS;
  const int steps = static_cast<int>(min(static_cast<long long>(TS), n - k0));
  const int lead = gpar::lead(k0 * DD);

  for (int s = tid; s < steps; s += nthr) {
    const long long k = k0 + s;
    const float Sk = S[k];
    float imk[D], A1[D][D];  // column 0 of I - K_k e1^T; A_{k+1}
#pragma unroll
    for (int l = 0; l < D; ++l) imk[l] = (l == 0 ? 1.0f : 0.0f) - K[k * D + l];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) A1[i][j] = k + 1 < n ? A[(k + 1) * DD + i * D + j] : 0.0f;
    float* c = sC + lead + s * DD;
    float* w = sW + lead + s * DD;
#pragma unroll
    for (int j = 0; j < D; ++j) {  // C_k[0][j] = (A_{k+1} (I - K e1^T))[j][0]
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < D; ++l) acc = fmaf(A1[j][l], imk[l], acc);
      c[j] = acc;
    }
#pragma unroll
    for (int i = 1; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) c[i * D + j] = A1[j][i];
#pragma unroll
    for (int q = 0; q < DD; ++q) w[q] = q == 0 ? 1.0f / Sk : 0.0f;
    sS[s] = Sk;
  }
  __syncthreads();
  store_range(C_out, sC, k0 * DD, steps * DD, tid, nthr);
  store_range(W_out, sW, k0 * DD, steps * DD, tid, nthr);

  // b: the block's contiguous range of (steps, D, B) floats, 16-byte units
  // of the output; row 0 of a step is e_k / S_k, the other rows zero.
  const int DB = D * B;
  const long long first = k0 * DB, end = first + static_cast<long long>(steps) * DB;
  const int units = (gpar::lead(first) + steps * DB + 3) / 4;
  for (int u = tid; u < units; u += nthr) {
    const long long g = (first & ~3LL) + 4LL * u;
    const int local = static_cast<int>(max(g, first) - first);
    int s = local / DB, rem = local - s * DB;
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[t] = 0.0f;
      if (g + t >= first && g + t < end) {
        if (rem < B) v[t] = __ldg(e + (k0 + s) * B + rem) / sS[s];
        if (++rem == DB) {
          rem = 0;
          ++s;
        }
      }
    }
    if (g >= first && g + 4 <= end) {
      *reinterpret_cast<float4*>(b_out + g) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (g + t >= first && g + t < end) b_out[g + t] = v[t];
    }
  }
}

// K5b's shared memory, in floats: slots for the tile's ranges of r and A,
// N (TS + 1 steps), m and P (from the step before the tile), e / u, K, S
// (TS), ct_U out, and ctsym where staged.  The groups' partials and ct_A,
// ct_Q, ct_R out take r's slot once the products are done.  Every slot is
// whole 16-byte units.
template <int D>
struct ScoreSmem {
  static constexpr int DD = D * D, RED = 2 * DD + 1;  // R2, Rm, u ctsym u^T
  int B, Bp, TS, G;
  bool staged;
  __host__ __device__ ScoreSmem(int B_, int TS_, int G_, bool staged_)
      : B(B_), Bp((B_ + 3) / 4 * 4), TS(TS_), G(G_), staged(staged_) {}
  __host__ __device__ int o_m() const {
    const int after = o_R() + gpar::slot_floats(TS);  // what takes r's slot later
    const int r = gpar::slot_floats((TS + 1) * D * B);
    return r > after ? r : after;
  }
  __host__ __device__ int o_u() const { return o_m() + gpar::slot_floats(TS * D * B); }
  __host__ __device__ int o_U() const { return o_u() + gpar::slot_floats(TS * B); }
  __host__ __device__ int o_A() const { return o_U() + gpar::slot_floats(TS * B); }
  __host__ __device__ int o_P() const { return o_A() + gpar::slot_floats((TS + 1) * DD); }
  __host__ __device__ int o_N() const { return o_P() + gpar::slot_floats(TS * DD); }
  __host__ __device__ int o_K() const { return o_N() + gpar::slot_floats((TS + 1) * DD); }
  __host__ __device__ int o_S() const { return o_K() + gpar::slot_floats(TS * D); }
  __host__ __device__ int o_ct() const { return o_S() + gpar::slot_floats(TS); }
  __host__ __device__ int floats() const { return o_ct() + (staged ? B * Bp : 0); }
  // in r's slot after the products: the groups' partials, then ct_A, ct_Q,
  // ct_R out
  __host__ __device__ int o_A2() const { return (G * TS * RED + 3) / 4 * 4; }
  __host__ __device__ int o_Q() const { return o_A2() + gpar::slot_floats(TS * DD); }
  __host__ __device__ int o_R() const { return o_Q() + gpar::slot_floats(TS * DD); }
};

template <int D>
__device__ __forceinline__ void smem_mat(const float* X, bool live, float out[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = live ? X[i * D + j] : 0.0f;
}

// A CUDA block of 1 to 4 warps on a tile of TS steps, as G groups of TS
// threads: thread (s, g) = (tid % TS, tid / TS) is on step k0 + s and
// takes the passes g, g + G, ... of 4 NCH columns of the products with
// ctsym, each pass's (d + 1) x 4 NCH sums in registers (ctsym's padded
// rows: one 16-byte unit per 4 columns, one address for a group).  Group 0
// sums the groups' partials in order and forms the step's ct_A, ct_Q, ct_R.
template <int D, int NCH, bool kStaged>
__global__ void __launch_bounds__(4 * kScoreSteps, 4)
adjoint_scores_kernel(const float* __restrict__ A, const float* __restrict__ P,
                      const float* __restrict__ K, const float* __restrict__ S,
                      const float* __restrict__ e, const float* __restrict__ m,
                      const float* __restrict__ r, const float* __restrict__ Nm,
                      const float* __restrict__ ct, const float* __restrict__ ct_ld_p,
                      long long n, int B, int TS, float* __restrict__ ct_A,
                      float* __restrict__ ct_Q, float* __restrict__ ct_R,
                      float* __restrict__ ct_U) {
  constexpr int DD = D * D, RED = ScoreSmem<D>::RED, CW = 4 * NCH;
  const int tid = threadIdx.x, nthr = blockDim.x, G = nthr / TS;
  const ScoreSmem<D> lay(B, TS, G, kStaged);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = tid % TS, g = tid / TS;
  const int DB = D * B, Bq = lay.Bp / 4, NP = (B + CW - 1) / CW;
  const long long k0 = static_cast<long long>(blockIdx.x) * TS, k = k0 + s;
  const long long m0 = k0 > 0 ? k0 - 1 : 0;  // m's and P's first staged step
  const int steps = static_cast<int>(min(static_cast<long long>(TS), n - k0));
  const int ahead = static_cast<int>(min(static_cast<long long>(TS) + 1, n - k0));
  const int behind = static_cast<int>(k0 + steps - 1 - m0);
  // two groups of copies: what u and the products need, then m, P and N,
  // which only the folds and the scores read and which land meanwhile
  stage_range(smem, r, k0 * DB, ahead * DB, n * DB, tid, nthr);
  stage_range(smem + lay.o_u(), e, k0 * B, steps * B, n * B, tid, nthr);
  stage_range(smem + lay.o_A(), A, k0 * DD, ahead * DD, n * DD, tid, nthr);
  stage_range(smem + lay.o_K(), K, k0 * D, steps * D, n * D, tid, nthr);
  stage_range(smem + lay.o_S(), S, k0, steps, n, tid, nthr);
  if (kStaged) stage_range(smem + lay.o_ct(), ct, 0, B * lay.Bp, B * lay.Bp, tid, nthr);
  __pipeline_commit();
  stage_range(smem + lay.o_m(), m, m0 * DB, behind * DB, n * DB, tid, nthr);
  stage_range(smem + lay.o_P(), P, m0 * DD, behind * DD, n * DD, tid, nthr);
  stage_range(smem + lay.o_N(), Nm, k0 * DD, ahead * DD, n * DD, tid, nthr);
  __pipeline_commit();
  const float ld = *ct_ld_p;
  __pipeline_wait_prior(1);
  __syncthreads();

  const bool live = s < steps, next = live && k + 1 < n;
  const float* xr = smem + gpar::lead(k0 * DB) + s * DB;  // r_k; r_{k+1} one step on
  const float* mp =  // m_{k-1}, none before the first step
      k > 0 ? smem + lay.o_m() + gpar::lead(m0 * DB) + static_cast<int>(k - 1 - m0) * DB
            : nullptr;
  float* xu = smem + lay.o_u() + gpar::lead(k0 * B) + s * B;  // e_k, then u_k in place
  float* xU = smem + lay.o_U() + gpar::lead(k0 * B) + s * B;
  const float* sA = smem + lay.o_A() + gpar::lead(k0 * DD) + s * DD;  // A_k; A_{k+1} on
  const float* sN = smem + lay.o_N() + gpar::lead(k0 * DD) + s * DD;  // N_k; N_{k+1} on
  const float* sK = smem + lay.o_K() + gpar::lead(k0 * D) + s * D;
  const float Sk = live ? smem[lay.o_S() + gpar::lead(k0) + s] : 1.0f;
  float AK[D];  // A_{k+1} K_k
  {
    float A1[D][D];
    smem_mat<D>(sA + DD, next, A1);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc = fmaf(A1[i][j], live ? sK[j] : 0.0f, acc);
      AK[i] = acc;
    }
  }
  if (live) {  // u = e / S - AK^T r_{k+1}, the columns g, g + G, ...
    for (int c = g; c < B; c += G) {
      float acc = 0.0f;
      if (next) {
#pragma unroll
        for (int i = 0; i < D; ++i) acc = fmaf(AK[i], xr[DB + i * B + c], acc);
      }
      xu[c] = xu[c] / Sk - acc;
    }
  }
  __syncthreads();

  // [K5b products] [r_k; u] ctsym, a pass of CW columns at a time, folded
  // at once into R2 = r ctsym r^T, Rm = r ctsym m_{k-1}^T, u ctsym u^T and
  // ct_U = 2 u ctsym
  float R2[D][D], Rm[D][D], ucu = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) R2[i][j] = Rm[i][j] = 0.0f;
  const float4* ct4 = reinterpret_cast<const float4*>(kStaged ? smem + lay.o_ct() : ct);
  // the second group's barrier comes in every thread's first pass, or
  // in a pass of nothing where a group has none
  for (int q = g; q < NP || q == g; q += G) {
    const bool cols = live && q < NP;
    const int c0 = q * CW, nv = min(NCH, Bq - c0 / 4);  // ctsym's 16-byte units here
    float y[D + 1][CW];
#pragma unroll
    for (int i = 0; i <= D; ++i)
#pragma unroll
      for (int j = 0; j < CW; ++j) y[i][j] = 0.0f;
#pragma unroll 1
    for (int b = 0; cols && b < B; ++b) {
      float x[D + 1];
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = xr[i * B + b];
      x[D] = xu[b];
#pragma unroll
      for (int v = 0; v < NCH; ++v) {
        const int at = b * Bq + c0 / 4 + v;
        const float4 w = v >= nv ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                         : kStaged ? ct4[at] : __ldg(ct4 + at);
#pragma unroll
        for (int i = 0; i <= D; ++i) {
          y[i][4 * v] = fmaf(x[i], w.x, y[i][4 * v]);
          y[i][4 * v + 1] = fmaf(x[i], w.y, y[i][4 * v + 1]);
          y[i][4 * v + 2] = fmaf(x[i], w.z, y[i][4 * v + 2]);
          y[i][4 * v + 3] = fmaf(x[i], w.w, y[i][4 * v + 3]);
        }
      }
    }
    if (q == g) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; cols && j < CW; ++j) {
      const int c = c0 + j;
      if (c >= B) break;
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int l = 0; l < D; ++l) {
          R2[i][l] = fmaf(y[i][j], xr[l * B + c], R2[i][l]);
          if (mp) Rm[i][l] = fmaf(y[i][j], mp[l * B + c], Rm[i][l]);
        }
      ucu = fmaf(y[D][j], xu[c], ucu);
      xU[c] = 2.0f * y[D][j];
    }
  }  // [end K5b products]
  __syncthreads();  // r's slot is free from here

  if (G > 1) {  // the groups' partials, summed in order by group 0
    if (live) {
      float* p = smem + (g * TS + s) * RED;
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          p[i * D + j] = R2[i][j];
          p[DD + i * D + j] = Rm[i][j];
        }
      p[2 * DD] = ucu;
    }
    __syncthreads();
    if (g == 0 && live) {
      for (int h = 1; h < G; ++h) {
        const float* o = smem + (h * TS + s) * RED;
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) {
            R2[i][j] += o[i * D + j];
            Rm[i][j] += o[DD + i * D + j];
          }
        ucu += o[2 * DD];
      }
    }
  }

  float* oA = smem + lay.o_A2();
  float* oQ = smem + lay.o_Q();
  float* oR = smem + lay.o_R();
  if (g == 0 && live) {  // the step's scores
    float Ak[D][D], Pp[D][D], Nk[D][D], N1[D][D], AP[D][D];
    smem_mat<D>(sA, true, Ak);
    smem_mat<D>(smem + lay.o_P() + gpar::lead(m0 * DD) + static_cast<int>(k - 1 - m0) * DD,
                k > 0, Pp);
    smem_mat<D>(sN, true, Nk);
    smem_mat<D>(sN + DD, next, N1);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(Ak[i][l], Pp[l][j], acc);
        AP[i][j] = acc;
      }
    float* oa = oA + gpar::lead(k0 * DD) + s * DD;
    float* oq = oQ + gpar::lead(k0 * DD) + s * DD;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float rap = 0.0f, nap = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) {
          rap = fmaf(R2[i][l], AP[l][j], rap);
          nap = fmaf(Nk[i][l], AP[l][j], nap);
        }
        oa[i * D + j] = -2.0f * (rap + Rm[i][j]) + (2.0f * ld) * nap;
        oq[i * D + j] = -R2[i][j] + ld * Nk[i][j];
      }
    float quad = 0.0f;  // AK^T N_{k+1} AK
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) quad = fmaf(AK[i] * N1[i][j], AK[j], quad);
    oR[gpar::lead(k0) + s] = -ucu + ld * (1.0f / Sk + quad);
  }
  __syncthreads();
  store_range(ct_A, oA, k0 * DD, steps * DD, tid, nthr);
  store_range(ct_Q, oQ, k0 * DD, steps * DD, tid, nthr);
  store_range(ct_R, oR, k0, steps, tid, nthr);
  store_range(ct_U, smem + lay.o_U(), k0 * B, steps * B, tid, nthr);
}

template <int D, int NCH, bool kStaged>
int launch_scores(const void* A, const void* P, const void* K, const void* S, const void* e,
                  const void* m, const void* r, const void* N, const void* ct, const void* ct_ld,
                  long long n, int B, void* ct_A, void* ct_Q, void* ct_R, void* ct_U,
                  cudaStream_t stream) {
  // 32 steps a tile, or the most (halving) whose block fits 64 KB of shared
  // memory (four blocks an SM), else one step if it fits a block at all;
  // then up to 4 warps while every group of TS threads has a pass
  const int NP = (B + 4 * NCH - 1) / (4 * NCH);
  int ts = kScoreSteps, smem = 0, warps = 1;
  for (; ts >= 1; ts /= 2) {
    warps = NP * ts / 32 < 1 ? 1 : (NP * ts / 32 > 4 ? 4 : NP * ts / 32);
    smem = static_cast<int>(sizeof(float)) *
           ScoreSmem<D>(B, ts, 32 * warps / ts, kStaged).floats();
    if (smem <= kSmemTarget || (ts == 1 && smem <= kSmemMax)) break;
  }
  if (ts == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + ts - 1) / ts;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(adjoint_scores_kernel<D, NCH, kStaged>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  adjoint_scores_kernel<D, NCH, kStaged><<<static_cast<unsigned>(blocks), 32 * warps, smem,
                                           stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(P), static_cast<const float*>(K),
      static_cast<const float*>(S), static_cast<const float*>(e), static_cast<const float*>(m),
      static_cast<const float*>(r), static_cast<const float*>(N), static_cast<const float*>(ct),
      static_cast<const float*>(ct_ld), n, B, ts, static_cast<float*>(ct_A),
      static_cast<float*>(ct_Q), static_cast<float*>(ct_R), static_cast<float*>(ct_U));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_scores_at(int B, const void* A, const void* P, const void* K, const void* S,
                     const void* e, const void* m, const void* r, const void* N, const void* ct,
                     const void* ct_ld, long long n, void* ct_A, void* ct_Q, void* ct_R,
                     void* ct_U, cudaStream_t stream) {
  // [K5b shape] passes of 8 columns where one holds B, else of 12; ctsym in
  // shared memory up to 32 KB
  const bool narrow = B <= 8;
  const bool staged = static_cast<long long>(B) * ((B + 3) / 4 * 4) <= 8192;
#define GPAR_K5B(NN, ST) \
  return launch_scores<D, NN, ST>(A, P, K, S, e, m, r, N, ct, ct_ld, n, B, ct_A, ct_Q, ct_R, ct_U, stream)
  if (narrow) GPAR_K5B(2, true);
  if (staged) GPAR_K5B(3, true);
  GPAR_K5B(3, false);
#undef GPAR_K5B
}

}  // namespace

extern "C" int adjoint_elements(int d, const void* A, const void* K, const void* S, const void* e,
                                long long n, int B, void* C, void* b, void* W, void* stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!gpar::aligned16({C, b, W})) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = (n + kElemSteps - 1) / kElemSteps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_K5A(DD)                                                                         \
  adjoint_elements_kernel<DD><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(            \
      static_cast<const float*>(A), static_cast<const float*>(K),                            \
      static_cast<const float*>(S), static_cast<const float*>(e), n, B,                      \
      static_cast<float*>(C), static_cast<float*>(b), static_cast<float*>(W))
  switch (d) {
    case 1: GPAR_K5A(1); break;
    case 2: GPAR_K5A(2); break;
    case 3: GPAR_K5A(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_K5A
  return static_cast<int>(cudaGetLastError());
}

extern "C" int adjoint_scores(int d, const void* A, const void* P, const void* K, const void* S,
                              const void* e, const void* m, const void* r, const void* N,
                              const void* ct, const void* ct_ld, long long n, int B, void* ct_A,
                              void* ct_Q, void* ct_R, void* ct_U, void* stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!gpar::aligned16({A, P, K, S, e, m, r, N, ct, ct_A, ct_Q, ct_R, ct_U}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_scores_at<1>(B, A, P, K, S, e, m, r, N, ct, ct_ld, n, ct_A, ct_Q, ct_R, ct_U, s);
    case 2: return launch_scores_at<2>(B, A, P, K, S, e, m, r, N, ct, ct_ld, n, ct_A, ct_Q, ct_R, ct_U, s);
    case 3: return launch_scores_at<3>(B, A, P, K, S, e, m, r, N, ct, ct_ld, n, ct_A, ct_Q, ct_R, ct_U, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
