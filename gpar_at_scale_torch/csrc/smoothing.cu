// The RTS smoother's elements over C columns (K7) on Hopper.
//
// No pallas_call is replaced: the JAX package leaves these elements to
// XLA's fusion (gpar_at_scale_tpu/ssm/blocked.py::smoothing_elements).  The
// port's tensor code for the same algebra (ssm/blocked.py::
// smoothing_elements, then g = m - E (A' m) over the columns) ran as
// batched 3 x 3 cuBLAS products, cats and 3 x C products, each an (n, d, d)
// or (n, d, C) temporary in device memory; this kernel does it in one pass.
// With the filtered moments m_k (d, C) and P_k (d, d), the transitions A_k
// and the process noise Q_k:
//
//   Pp = A_{k+1} P_k A_{k+1}^T + Q_{k+1},   E_k = P_k A_{k+1}^T Pp^-1,
//   L_k = P_k - E_k Pp E_k^T,               g_k = m_k - E_k A_{k+1} m_k,
//
// in that form and in float32, with A_n = 0 and Q_n = I after the last step
// (the terminal element (0, m, P)); Pp^-1 is the adjugate over the
// determinant, as ssm/pkalman.py::_inv_small.  g is written in place over m,
// the suffix scan's (K4a/K4b) input.
//
// What bounds it: bytes.  At d = 3, C = 33 a step reads A, Q, P (36 bytes
// each) and m (396) and writes E, L (36 each) and g (396): 972 bytes against
// about 1 kFLOP -- at 6.46e7 steps 62.8 GB, 18.8 ms at 3.35 TB/s, against
// 1 ms of float32 arithmetic.  So each byte moves once, in 16-byte units:
//
//   a CUDA block owns a tile of TS consecutive steps (a multiple of 4, so
//   that the tile's range of every array starts on a 16-byte boundary: 32
//   steps at C = 33, fewer at wide C) and stages the tile's contiguous
//   ranges with 16-byte cp.async in two groups: P, and A and Q with the
//   step after the tile, first, then m.  While m lands, one thread a step
//   forms the step's d x d algebra in registers, writes E and L into shared
//   memory and F = E A_{k+1} beside them; E and L go out as 16-byte stores.
//   Then thread j takes step j / C and column j % C of the tile, replaces
//   its d rows of m by g = m - F m in shared memory, and the tile goes back
//   out over m as 16-byte stores.  No (n, d, d) or (n, d, C) temporary
//   exists.
//
// Plain C interface (built with nvcc, loaded with ctypes): the entry returns
// cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSteps = 32;      // steps per CUDA block, at most
constexpr int kTileFloats = 4096;  // m's tile, at most, down to 4 steps
constexpr int kSmemMax = 232448;   // a block's most shared memory on Hopper

using gpar::slot_floats;

// Shared memory, in floats: slots for the tile's ranges of P (TS steps),
// A and Q (TS + 1 steps) and m (TS steps of D C floats), then E and L out
// (TS steps each) and F (TS steps).  Every slot is whole 16-byte units.
template <int D>
struct Smem {
  static constexpr int DD = D * D;
  int TS, DC;
  __host__ __device__ Smem(int TS_, int C) : TS(TS_), DC(D * C) {}
  __host__ __device__ int o_A() const { return slot_floats(TS * DD); }
  __host__ __device__ int o_Q() const { return o_A() + slot_floats((TS + 1) * DD); }
  __host__ __device__ int o_m() const { return o_Q() + slot_floats((TS + 1) * DD); }
  __host__ __device__ int o_E() const { return o_m() + slot_floats(TS * DC); }
  __host__ __device__ int o_L() const { return o_E() + slot_floats(TS * DD); }
  __host__ __device__ int o_F() const { return o_L() + slot_floats(TS * DD); }
  __host__ __device__ int floats() const { return o_F() + TS * DD; }
};

template <int D>
__device__ __forceinline__ void load_mat(const float* X, float out[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = X[i * D + j];
}

// Z^-1 by the adjugate (ssm/pkalman.py::_inv_small): at d = 3 column j of
// the adjugate is the cross product of rows j + 1 and j + 2 of Z.
template <int D>
__device__ __forceinline__ void inv_small(const float Z[D][D], float out[D][D]) {
  if constexpr (D == 1) {
    out[0][0] = 1.0f / Z[0][0];
  } else if constexpr (D == 2) {
    const float det = Z[0][0] * Z[1][1] - Z[0][1] * Z[1][0];
    out[0][0] = Z[1][1] / det;
    out[0][1] = -Z[0][1] / det;
    out[1][0] = -Z[1][0] / det;
    out[1][1] = Z[0][0] / det;
  } else {
    float c[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int a = (j + 1) % 3, b = (j + 2) % 3;
      c[j][0] = Z[a][1] * Z[b][2] - Z[a][2] * Z[b][1];
      c[j][1] = Z[a][2] * Z[b][0] - Z[a][0] * Z[b][2];
      c[j][2] = Z[a][0] * Z[b][1] - Z[a][1] * Z[b][0];
    }
    const float det = Z[0][0] * c[0][0] + Z[0][1] * c[0][1] + Z[0][2] * c[0][2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) out[i][j] = c[j][i] / det;
  }
}

// One step's E, L and F = E A_{k+1} from P_k, A_{k+1} and Q_{k+1} (zero and
// I after the last step), each product in the tensor code's order.
template <int D>
__device__ __forceinline__ void step_elements(const float* sP, const float* sA1, const float* sQ1,
                                              bool next, float* sE, float* sL, float* sF) {
  float Pk[D][D], A1[D][D], Pp[D][D], Pi[D][D], Ek[D][D];
  load_mat<D>(sP, Pk);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) A1[i][j] = next ? sA1[i * D + j] : 0.0f;
  {  // Pp = (A1 P) A1^T + Q1
    float AP[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(A1[i][l], Pk[l][j], acc);
        AP[i][j] = acc;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(AP[i][l], A1[j][l], acc);
        Pp[i][j] = acc + (next ? sQ1[i * D + j] : (i == j ? 1.0f : 0.0f));
      }
  }
  inv_small<D>(Pp, Pi);
  {  // E = (P A1^T) Pp^-1
    float PAt[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(Pk[i][l], A1[j][l], acc);
        PAt[i][j] = acc;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(PAt[i][l], Pi[l][j], acc);
        Ek[i][j] = acc;
        sE[i * D + j] = acc;
      }
  }
  {  // L = P - (E Pp) E^T
    float EPp[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(Ek[i][l], Pp[l][j], acc);
        EPp[i][j] = acc;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int l = 0; l < D; ++l) acc = fmaf(EPp[i][l], Ek[j][l], acc);
        sL[i * D + j] = Pk[i][j] - acc;
      }
  }
#pragma unroll
  for (int i = 0; i < D; ++i)  // F = E A1
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < D; ++l) acc = fmaf(Ek[i][l], A1[l][j], acc);
      sF[i * D + j] = acc;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
smoothing_elements_kernel(const float* __restrict__ A, const float* __restrict__ Q,
                          const float* __restrict__ P, float* m, long long n, int C, int TS,
                          float* __restrict__ E_out, float* __restrict__ L_out) {
  constexpr int DD = D * D;
  const Smem<D> lay(TS, C);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x, DC = D * C;
  const long long k0 = static_cast<long long>(blockIdx.x) * TS;
  const int steps = static_cast<int>(min(static_cast<long long>(TS), n - k0));
  const int ahead = static_cast<int>(min(static_cast<long long>(TS) + 1, n - k0));
  // two groups of copies: what the d x d algebra reads, then m's tile,
  // which lands while the algebra runs
  gpar::stage_range(smem, P, k0 * DD, steps * DD, n * DD, tid, nthr);
  gpar::stage_range(smem + lay.o_A(), A, k0 * DD, ahead * DD, n * DD, tid, nthr);
  gpar::stage_range(smem + lay.o_Q(), Q, k0 * DD, ahead * DD, n * DD, tid, nthr);
  __pipeline_commit();
  gpar::stage_range(smem + lay.o_m(), m, k0 * DC, steps * DC, n * DC, tid, nthr);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();

  const int lead = gpar::lead(k0 * DD);  // of every d x d range in its slot
  for (int s = tid; s < steps; s += nthr) {
    const int at = lead + s * DD;  // step k0 + s; the step after it at + DD
    step_elements<D>(smem + at, smem + lay.o_A() + at + DD, smem + lay.o_Q() + at + DD,
                     k0 + s + 1 < n, smem + lay.o_E() + at, smem + lay.o_L() + at,
                     smem + lay.o_F() + s * DD);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  gpar::store_range(E_out, smem + lay.o_E(), k0 * DD, steps * DD, tid, nthr);
  gpar::store_range(L_out, smem + lay.o_L(), k0 * DD, steps * DD, tid, nthr);

  // g = m - F m in place over the tile: thread j on step j / C, column j % C
  float* tile = smem + lay.o_m() + gpar::lead(k0 * DC);
  for (int j = tid; j < steps * C; j += nthr) {
    const int s = j / C, c = j - s * C;
    const float* F = smem + lay.o_F() + s * DD;
    float* x = tile + s * DC + c;
    float v[D];
#pragma unroll
    for (int l = 0; l < D; ++l) v[l] = x[l * C];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < D; ++l) acc = fmaf(F[i * D + l], v[l], acc);
      x[i * C] = v[i] - acc;
    }
  }
  __syncthreads();
  gpar::store_range(m, smem + lay.o_m(), k0 * DC, steps * DC, tid, nthr);
}

template <int D>
int launch(const void* A, const void* Q, const void* P, void* m, long long n, int C, void* E,
           void* L, cudaStream_t stream) {
  // TS: a multiple of 4 up to kMaxSteps, m's tile within kTileFloats where
  // C allows
  const int ts = max(4, min(kMaxSteps, kTileFloats / (D * C) / 4 * 4));
  const long long floats = Smem<D>(ts, C).floats();
  if (floats * static_cast<long long>(sizeof(float)) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(floats * sizeof(float));
  const long long blocks = (n + ts - 1) / ts;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(smoothing_elements_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  smoothing_elements_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Q), static_cast<const float*>(P),
      static_cast<float*>(m), n, C, ts, static_cast<float*>(E), static_cast<float*>(L));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int smoothing_elements(int d, const void* A, const void* Q, const void* P, void* m,
                                  long long n, int C, void* E, void* L, void* stream) {
  if (n < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!gpar::aligned16({A, Q, P, m, E, L})) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(A, Q, P, m, n, C, E, L, s);
    case 2: return launch<2>(A, Q, P, m, n, C, E, L, s);
    case 3: return launch<3>(A, Q, P, m, n, C, E, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
