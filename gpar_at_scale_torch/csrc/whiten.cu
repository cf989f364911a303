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
// training path asks for it.
//
// What bounds it on this card: bytes.  Per step the sweep must read a gain
// row (18 floats at d = 3) and B values of Y and write B alphas (and d B
// means): 0.10 ms at N = 1e6, B = 33 (0.22 ms with the means) at 3.35 TB/s,
// against 0.01 ms of float32 operations.  Run as one chain per column (one
// thread through all N dependent steps) it would be latency-bound instead,
// with only B threads busy.  So time is cut into nb blocks of T steps (the blocking of
// K1/K2, ssm/blocked.py::num_blocks_for: 16384 blocks of 62 steps at
// N = 1e6), and the recursion, affine once the gains are fixed, runs in
// three phases (four launches):
//
//   1. sweep_kernel<D, false>: per (time block, column), the block's
//      composed map m -> Mt m + ct from m = 0, with masked steps the
//      identity.  Mt (d x d) does not depend on the column: one extra warp
//      computes it once per time block, a lane per block.
//   2. prefix_kernel: per column, an exclusive prefix over the nb block maps
//      (a CUDA block per column, walking the blocks in tiles of 512 with a
//      warp-shuffle scan), which gives the mean entering every time block.
//   3. sweep_kernel<D, true>: per (time block, column), the replay from the
//      entering mean; it writes alpha and the means, and each time block's
//      float32 partial of ll, which each CUDA block sums over its time
//      blocks in double.
//   4. ll_sum_kernel: per column, those sums summed in double (a float32
//      sum over 1e6 steps loses about 1e-3 of its value).
//
// Phases 1 and 3 read gains and Y once each, so the design moves about
// (2 (G + B) + B) * 4 bytes per step.  A CUDA block owns tbc consecutive
// time blocks and bt <= 64 columns: thread i carries column i % bt of time
// block i / bt, so a warp holds 32 neighbouring columns (B = 33 puts 7 time
// blocks on 231 threads) and never a lone one.  The time blocks' gain rows
// and Y tiles are staged through shared memory by cp.async in chunks of
// kChunk steps, double buffered, read coalesced; one gain row serves every
// column of its block as a broadcast.  Alphas and means are stored from
// registers, neighbouring threads on neighbouring floats.
//
// Plain C interface (built with nvcc, loaded with ctypes): the entry
// returns cudaGetLastError() after the launches.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kChunk = 16;        // steps of each time block per shared-memory stage
constexpr int kColTile = 64;      // most columns a CUDA block carries
constexpr int kColThreads = 256;  // column threads a CUDA block aims for
constexpr int kMaxTB = 32;        // most time blocks per CUDA block (a lane each in phase 1)
constexpr int kMaxThreads = kColThreads + 32;
constexpr int kScanThreads = 512;

template <int D>
struct Aff {  // the affine map m -> P m + c
  float P[D][D];
  float c[D];
};

template <int D>
__device__ __forceinline__ Aff<D> identity_map() {
  Aff<D> r;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    r.c[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) r.P[i][j] = i == j ? 1.0f : 0.0f;
  }
  return r;
}

// later o earlier: m -> later.P (earlier.P m + earlier.c) + later.c
template <int D>
__device__ __forceinline__ Aff<D> compose(const Aff<D>& earlier, const Aff<D>& later) {
  Aff<D> r;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = later.c[i];
#pragma unroll
    for (int l = 0; l < D; ++l) s += later.P[i][l] * earlier.c[l];
    r.c[i] = s;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float p = 0.0f;
#pragma unroll
      for (int l = 0; l < D; ++l) p += later.P[i][l] * earlier.P[l][j];
      r.P[i][j] = p;
    }
  }
  return r;
}

template <int D>
__device__ __forceinline__ Aff<D> shfl_up(const Aff<D>& x, int off) {
  Aff<D> r;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    r.c[i] = __shfl_up_sync(0xffffffffu, x.c[i], off);
#pragma unroll
    for (int j = 0; j < D; ++j) r.P[i][j] = __shfl_up_sync(0xffffffffu, x.P[i][j], off);
  }
  return r;
}

// Inclusive scan of one map per lane over the warp (lane 0 first).
template <int D>
__device__ __forceinline__ Aff<D> warp_scan(Aff<D> x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const Aff<D> y = shfl_up(x, off);
    if (lane >= off) x = compose(y, x);
  }
  return x;
}

// A gain row in shared memory, padded to GP floats so that it is read as
// GP / 4 16-byte loads.
template <int D>
__host__ __device__ constexpr int gain_pad() { return (3 + 2 * D + D * D + 3) / 4 * 4; }

template <int GP>
__device__ __forceinline__ void load_row(const float* g, float (&r)[GP]) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
  for (int v = 0; v < GP / 4; ++v) {
    const float4 q = g4[v];
    r[4 * v] = q.x;
    r[4 * v + 1] = q.y;
    r[4 * v + 2] = q.z;
    r[4 * v + 3] = q.w;
  }
}

// Phases 1 (kReplay false) and 3 (kReplay true).  CUDA block (x, y) owns
// time blocks [x tbc, x tbc + tbc) and columns [y bt, y bt + bt).  Time
// block b covers steps [b T, min((b + 1) T, n)): steps past n are the
// padding of the plain version (S = 1, mask = 0), the identity, and are
// skipped.
template <int D, bool kReplay>
__global__ void __launch_bounds__(kMaxThreads)
sweep_kernel(const float* __restrict__ gains, const float* __restrict__ Y, long long n, int B,
             int nb, int T, int tbc, int bt, float* __restrict__ Mt, float* __restrict__ ct,
             const float* __restrict__ m_in, float* __restrict__ alpha,
             float* __restrict__ m_out, double* __restrict__ llc) {
  constexpr int G = 3 + 2 * D + D * D;
  constexpr int GP = gain_pad<D>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sg = smem;                           // [2][tbc][kChunk][GP]
  float* sy = sg + 2 * tbc * kChunk * GP;     // [2][tbc][kChunk][bt]
  __shared__ int s_len[kMaxTB];               // steps of each time block

  const int tid = threadIdx.x;
  const int tb0 = blockIdx.x * tbc;
  const int c0 = blockIdx.y * bt;
  const int ncols = min(bt, B - c0);
  if (tid < tbc) {
    const long long first = static_cast<long long>(tb0 + tid) * T;
    s_len[tid] = (tb0 + tid < nb && first < n)
                     ? static_cast<int>(min(static_cast<long long>(T), n - first)) : 0;
  }
  __syncthreads();

  // A time block with no steps (padding only) is the identity map: its
  // threads take no step and write m = 0 (phase 1) or an ll partial of 0.
  const int col_threads = tbc * bt;
  const int j = tid / bt, col = tid % bt;
  const bool is_col = tid < col_threads && col < ncols && tb0 + j < nb;
  const int jm = tid - (col_threads + 31) / 32 * 32;  // lane of the matrix warp (phase 1)
  const bool is_mat = !kReplay && jm >= 0 && jm < tbc && tb0 + jm < nb;
  const int my_len = is_col ? s_len[j] : (is_mat ? s_len[jm] : 0);

  // Copy chunk ch (steps [ch kChunk, ch kChunk + kChunk) of every time
  // block) into buffer ch & 1 with cp.async, as one commit group.
  auto stage = [&](int ch) {
    const int t0 = ch * kChunk, buf = ch & 1;
    for (int jj = 0; jj < tbc; ++jj) {
      const int rows = min(kChunk, s_len[jj] - t0);
      if (rows <= 0) continue;
      const long long row0 = static_cast<long long>(tb0 + jj) * T + t0;
      const float* gsrc = gains + row0 * G;
      float* gd = sg + (buf * tbc + jj) * kChunk * GP;
      for (int r = tid; r < rows * G; r += blockDim.x)
        __pipeline_memcpy_async(gd + (r / G) * GP + r % G, gsrc + r, 4);
      float* yd = sy + (buf * tbc + jj) * kChunk * bt;
      if (ncols == B) {  // one column tile: the rows are contiguous in Y
        const float* ysrc = Y + row0 * B;
        for (int r = tid; r < rows * B; r += blockDim.x) __pipeline_memcpy_async(yd + r, ysrc + r, 4);
      } else {
        for (int r = tid; r < rows * ncols; r += blockDim.x) {
          const int t = r / ncols, cc = r % ncols;
          __pipeline_memcpy_async(yd + t * bt + cc, Y + (row0 + t) * B + c0 + cc, 4);
        }
      }
    }
    __pipeline_commit();
  };

  float m[D];
  float P[D][D];
  float part = 0.0f;
  const long long tb = tb0 + (is_col ? j : jm);
  const long long gcol = c0 + col;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m[i] = (kReplay && is_col) ? m_in[(gcol * nb + tb) * D + i] : 0.0f;
#pragma unroll
    for (int l = 0; l < D; ++l) P[i][l] = i == l ? 1.0f : 0.0f;
  }

  const int nch = (T + kChunk - 1) / kChunk;
  stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int buf = ch & 1;
    const int rows = min(kChunk, my_len - ch * kChunk);
    if (is_col) {
      const float* g = sg + (buf * tbc + j) * kChunk * GP;
      const float* yv = sy + (buf * tbc + j) * kChunk * bt + col;
      const long long k0 = tb * T + ch * kChunk;
      for (int t = 0; t < rows; ++t) {
        float gr[GP];
        load_row(g + t * GP, gr);
        const float mask = gr[2];
        const float yk = yv[t * bt];
        float m_new[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int l = 0; l < D; ++l) s += gr[3 + 2 * D + i * D + l] * m[l];
          m_new[i] = s + gr[3 + i] * yk;
        }
        if (kReplay) {
          float v = yk;
#pragma unroll
          for (int l = 0; l < D; ++l) v -= gr[3 + D + l] * m[l];
          const float a = v * rsqrtf(gr[0]) * mask;
          part -= 0.5f * mask * (kLog2Pi + gr[1] + a * a);
          alpha[(k0 + t) * B + gcol] = a;
        }
        if (mask > 0.5f) {
#pragma unroll
          for (int i = 0; i < D; ++i) m[i] = m_new[i];
        }
        if (kReplay && m_out != nullptr) {
#pragma unroll
          for (int i = 0; i < D; ++i) m_out[((k0 + t) * D + i) * B + gcol] = m[i];
        }
      }
    } else if (is_mat) {
      const float* g = sg + (buf * tbc + jm) * kChunk * GP;
      for (int t = 0; t < rows; ++t) {
        float gr[GP];
        load_row(g + t * GP, gr);
        if (gr[2] > 0.5f) {
          float Pn[D][D];
#pragma unroll
          for (int i = 0; i < D; ++i)
#pragma unroll
            for (int l = 0; l < D; ++l) {
              float s = 0.0f;
#pragma unroll
              for (int q = 0; q < D; ++q) s += gr[3 + 2 * D + i * D + q] * P[q][l];
              Pn[i][l] = s;
            }
#pragma unroll
          for (int i = 0; i < D; ++i)
#pragma unroll
            for (int l = 0; l < D; ++l) P[i][l] = Pn[i][l];
        }
      }
    }
    __syncthreads();
  }

  if (kReplay) {
    // the time blocks' float partials of ll, summed in double in block order
    float* sp = smem;
    if (is_col) sp[j * bt + col] = part;
    __syncthreads();
    if (tid < ncols) {
      double acc = 0.0;
      for (int jj = 0; jj < tbc && tb0 + jj < nb; ++jj) acc += static_cast<double>(sp[jj * bt + tid]);
      llc[static_cast<long long>(blockIdx.x) * B + c0 + tid] = acc;
    }
  } else if (is_col) {
#pragma unroll
    for (int i = 0; i < D; ++i) ct[(gcol * nb + tb) * D + i] = m[i];
  } else if (is_mat && blockIdx.y == 0) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int l = 0; l < D; ++l) Mt[(tb * D + i) * D + l] = P[i][l];
  }
}

template <int D>
__device__ __forceinline__ Aff<D> shfl_from(const Aff<D>& x, int src) {
  Aff<D> r;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    r.c[i] = __shfl_sync(0xffffffffu, x.c[i], src);
#pragma unroll
    for (int j = 0; j < D; ++j) r.P[i][j] = __shfl_sync(0xffffffffu, x.P[i][j], src);
  }
  return r;
}

// Phase 2: CUDA block `col` turns the block maps (Mt (nb, D, D), ct (B, nb,
// D)) into the mean entering each time block, m_in (B, nb, D), with
// m_in[0] = 0.  It walks the blocks in tiles of kScanThreads, a block per
// thread (coalesced loads, the next tile's loaded ahead): a warp-shuffle
// scan within each warp, then over the warps' totals, and a carried map of
// all earlier tiles.
template <int D>
__global__ void __launch_bounds__(kScanThreads)
prefix_kernel(const float* __restrict__ Mt, const float* __restrict__ ct, int nb,
              float* __restrict__ m_in) {
  constexpr int kWarps = kScanThreads / 32;
  __shared__ Aff<D> wtot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long col = blockIdx.x;
  const float* cc = ct + col * nb * D;
  float* mo = m_in + col * nb * D;

  auto load = [&](int b) {
    Aff<D> x = identity_map<D>();
    if (b < nb) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        x.c[i] = cc[static_cast<long long>(b) * D + i];
#pragma unroll
        for (int l = 0; l < D; ++l) x.P[i][l] = Mt[(static_cast<long long>(b) * D + i) * D + l];
      }
    }
    return x;
  };

  Aff<D> carry = identity_map<D>();  // the maps of every earlier tile
  Aff<D> next = load(threadIdx.x);
  for (int base = 0; base < nb; base += kScanThreads) {
    const int b = base + threadIdx.x;
    Aff<D> x = warp_scan(next, lane);
    next = load(b + kScanThreads);
    Aff<D> ex = shfl_up(x, 1);  // the maps of the warp's earlier lanes
    if (lane == 0) ex = identity_map<D>();
    if (lane == 31) wtot[warp] = x;
    __syncthreads();
    Aff<D> z = warp_scan(lane < kWarps ? wtot[lane] : identity_map<D>(), lane);
    Aff<D> wex = shfl_from(z, warp > 0 ? warp - 1 : 0);  // the tile's earlier warps
    if (warp == 0) wex = identity_map<D>();
    const Aff<D> tile = shfl_from(z, kWarps - 1);
    float before[D], m[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = wex.c[i];
#pragma unroll
      for (int l = 0; l < D; ++l) s += wex.P[i][l] * carry.c[l];
      before[i] = s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = ex.c[i];
#pragma unroll
      for (int l = 0; l < D; ++l) s += ex.P[i][l] * before[l];
      m[i] = s;
    }
    if (b < nb) {
#pragma unroll
      for (int i = 0; i < D; ++i) mo[static_cast<long long>(b) * D + i] = m[i];
    }
    carry = compose(carry, tile);
    __syncthreads();
  }
}

// Phase 4: ll[c] = sum over rows of llc[r, c] (a row per CUDA block of
// phase 3) in double, in a fixed order.
__global__ void __launch_bounds__(1024)
ll_sum_kernel(const double* __restrict__ llc, int rows, int B, float* __restrict__ ll) {
  __shared__ double s[32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  double acc = 0.0;
  if (col < B) {
#pragma unroll 8
    for (int r = w; r < rows; r += 32) acc += llc[static_cast<long long>(r) * B + col];
  }
  s[w][lane] = acc;
  __syncthreads();
  if (w == 0 && col < B) {
    double t = 0.0;
    for (int k = 0; k < 32; ++k) t += s[k][lane];
    ll[col] = static_cast<float>(t);
  }
}

template <int D>
int launch(const float* gains, const float* Y, long long n, int B, int nb, int T, float* alpha,
           float* ll, float* m_out, float* scratch, cudaStream_t s) {
  const int bt = min(B, kColTile);
  const int tbc = max(1, min(kMaxTB, kColThreads / bt));
  const int col_threads = (tbc * bt + 31) / 32 * 32;
  const dim3 grid((nb + tbc - 1) / tbc, (B + bt - 1) / bt);
  const size_t smem = sizeof(float) * 2 * tbc * kChunk * (gain_pad<D>() + bt);
  double* llc = reinterpret_cast<double*>(scratch);  // (grid.x, B)
  float* Mt = scratch + 2LL * nb * B;
  float* ct = Mt + static_cast<long long>(nb) * D * D;
  float* m_in = ct + static_cast<long long>(B) * nb * D;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(sweep_kernel<D, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess ||
      (e = cudaFuncSetAttribute(sweep_kernel<D, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(e);
  sweep_kernel<D, false><<<grid, col_threads + 32, smem, s>>>(gains, Y, n, B, nb, T, tbc, bt, Mt,
                                                              ct, nullptr, nullptr, nullptr,
                                                              nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  prefix_kernel<D><<<B, kScanThreads, 0, s>>>(Mt, ct, nb, m_in);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  sweep_kernel<D, true><<<grid, col_threads, smem, s>>>(gains, Y, n, B, nb, T, tbc, bt, nullptr,
                                                        nullptr, m_in, alpha, m_out, llc);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ll_sum_kernel<<<(B + 31) / 32, 1024, 0, s>>>(llc, grid.x, B, ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The sweep of the B columns of Y (n, B) over nb time blocks of T steps
// (nb T >= n).  scratch holds nb (d d + 2 B d + 2 B) floats, 8-byte aligned.
extern "C" int whiten_columns(int d, const void* gains, const void* Y, long long n, int B, int nb,
                              int T, void* alpha, void* ll, void* m_out, void* scratch,
                              void* stream) {
  if (n < 1 || B < 1 || nb < 1 || T < 1 || static_cast<long long>(nb) * T < n || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_W(DD)                                                                           \
  return launch<DD>(static_cast<const float*>(gains), static_cast<const float*>(Y), n, B, nb, \
                    T, static_cast<float*>(alpha), static_cast<float*>(ll),                  \
                    static_cast<float*>(m_out), static_cast<float*>(scratch), s)
  switch (d) {
    case 1: GPAR_W(1);
    case 2: GPAR_W(2);
    case 3: GPAR_W(3);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_W
}
