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
// E and L are shared by the C columns; only g carries them.  Steps at or
// past n do not exist: a block stops at n, which is the JAX kernels'
// identity padding.  The TPU kernel ran 1024 lanes in lockstep over a
// sequential grid; here the step loop runs inside each thread and the
// blocks in no order.
//
// What bounds them: at the main path's C = 33 columns K4a reads
// 4 (2 d^2 + d C) bytes per step and K4b reads as much and writes
// 4 (d C + d^2) -- about 0.47 and 0.90 GB at n = 1e6, d = 3 -- for a few
// FMAs per byte, so bytes bound them.
//
// K4a has two kinds of thread in one grid: nblocks * C column threads (one
// per block and column; the columns of one block are neighbours in a warp,
// so their g rows are read coalesced and E_k is one broadcast), and after
// them nblocks matrix threads (one per block) that run the d x d E / L
// recursion, reading their rows straight from device memory.
//
// K4b is staged.  A CUDA block owns tbc consecutive time blocks and a tile
// of bt <= 64 columns, as K3 does (whiten.cu): thread i carries column
// i % bt of time block i / bt (C = 33 puts 7 time blocks on 231 threads;
// C = 1 puts 32 time blocks, a column each, on one warp), and one more
// warp runs the M recursion of the tile's time blocks, a lane each, in the
// first column tile; wider C tiles the columns over the grid's y axis.  So
// no CUDA block carries the M recursion alone.  A CUDA block has at least
// eight warps: at C = 1 six more only stage and store, since with two the
// copies' address arithmetic, not the bytes, set the pace.  Each time
// block is walked backwards in chunks of at most kChunk = 8 steps (aligned
// to the series as K2's are where the chunks' g rows are short, as at
// C = 1; staging.cuh): a chunk's E, L and g rows of one time
// block are one contiguous range per array (g: one range per row (step,
// component) when the columns are tiled), copied into shared memory with
// 16-byte cp.async, double buffered (staging.cuh).  E_k is then read from
// device memory once per CUDA block, not once per column thread.  v and M
// are written to shared memory in place over g and L, and each chunk's
// ranges are stored with 16-byte stores where whole.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 128;  // K4a

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

// K4b's stage.  A CUDA block owns tbc consecutive time blocks and a tile
// of bt <= kColTile columns: thread i carries column i % bt of time block
// i / bt (tbc bt <= kColThreads), and one more warp, in the first column
// tile only, runs the M recursion, a lane per time block (tbc <= 32).
// Each time block is walked backwards in chunks of at most kChunk steps
// (gpar::window), its last chunk first.  Per time
// block and buffer a chunk holds slots of E and L (kChunk d^2 floats each)
// and of g: one range of kChunk d C floats when the tile holds every
// column, else kChunk d ranges of bt floats (a row's columns of the tile).
// v and M are written in place over g and L, which their step has read.
constexpr int kChunk = 8;
constexpr int kColTile = 64;
constexpr int kColThreads = 256;
constexpr int kMaxTB = 32;

template <int D>
struct R3Smem {
  static constexpr int SE = gpar::slot_floats(kChunk * D * D);
  int tbc, bt, gseg, nseg;  // time blocks, columns; g's slot floats and slots per block
  __host__ __device__ R3Smem(int C, int tbc_, int bt_) : tbc(tbc_), bt(bt_) {
    const bool whole = bt == C;
    gseg = whole ? gpar::slot_floats(kChunk * D * C) : gpar::slot_floats(bt);
    nseg = whole ? 1 : kChunk * D;
  }
  __host__ __device__ int SG() const { return gseg * nseg; }
  __host__ __device__ int buf() const { return tbc * (2 * SE + SG()); }  // E, L, g
  __host__ __device__ int floats() const { return 2 * buf(); }
};

template <int D>
__global__ void __launch_bounds__(kColThreads + 32)
suffix_replay_kernel(const float* __restrict__ E, const float* __restrict__ g,
                     const float* __restrict__ L, long long n, long long T, int nblocks, int C,
                     int tbc, int bt, bool aligned, const float* __restrict__ g0,
                     const float* __restrict__ L0,
                     float* __restrict__ v_out, float* __restrict__ M_out) {
  constexpr int CH = kChunk, DD = D * D;
  const R3Smem<D> lay(C, tbc, bt);
  const int UG = lay.gseg / 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_len[kMaxTB], s_org[kMaxTB], s_nw[kMaxTB];  // steps, chunk origin, chunks
  __shared__ int s_nch;  // chunks of the CUDA block: the most of any time block

  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long tb0 = static_cast<long long>(blockIdx.x) * tbc;
  const int c0 = blockIdx.y * bt;
  const int ncols = min(bt, C - c0);
  const bool whole = ncols == C;
  const bool mat = blockIdx.y == 0;  // the first column tile runs the M recursion
  if (tid < 32) {  // warp 0: a lane per time block
    const long long b = tb0 + tid;
    const int len = tid < tbc && b < nblocks ? static_cast<int>(max(0LL, min(T, n - b * T))) : 0;
    const int org = gpar::window_origin<CH>(b * T, len, aligned);
    const int nw = gpar::windows<CH>(org, len);
    if (tid < tbc) {
      s_len[tid] = len;
      s_org[tid] = org;
      s_nw[tid] = nw;
    }
    const int most = __reduce_max_sync(0xffffffffu, nw);
    if (tid == 0) s_nch = most;
  }
  __syncthreads();

  // Buffer ch & 1: [E: tbc][SE], [L: tbc][SE], [g: tbc][SG].
  auto buffer = [&](int ch) { return smem + (ch & 1) * lay.buf(); };
  // Chunk ch of the walk of time block tb0 + j, backwards from its last
  // chunk (staging.cuh): its rows and its first step.
  auto rows_of = [&](int j, int ch, long long& k0) {
    int lo;
    const int rows = gpar::window<CH>(s_org[j], s_len[j], s_nw[j] - 1 - ch, lo);
    k0 = (tb0 + j) * T + lo;
    return rows;
  };
  // g's range of slot q of a chunk starting at step k0: the whole chunk, or
  // row (t, i) = (q / D, q % D) of the tile.
  auto g_first = [&](long long k0, int q) {
    return whole ? k0 * D * C : ((k0 + q / D) * D + q % D) * C + c0;
  };

  // fn(offset in the g slots, first, count, u) for each unit u of chunk
  // ch's g ranges.
  auto g_units = [&](int ch, auto fn) {
    const int nseg = lay.nseg;
    for (int r = tid; r < tbc * nseg * UG; r += nthr) {
      const int js = r / UG, u = r - js * UG, j = js / nseg, q = js - j * nseg;
      long long k0;
      const int rows = rows_of(j, ch, k0);
      if (rows > 0 && q < (whole ? 1 : rows * D))
        fn(js * lay.gseg, g_first(k0, q), whole ? rows * D * C : ncols, u);
    }
  };

  auto stage = [&](int ch) {
    float* buf = buffer(ch);
    auto chunk = [&](int j, long long& k0) { return rows_of(j, ch, k0); };
    gpar::ranges_in<DD, R3Smem<D>::SE>(buf, E, n, tbc, chunk, tid, nthr);
    if (mat) gpar::ranges_in<DD, R3Smem<D>::SE>(buf + tbc * lay.SE, L, n, tbc, chunk, tid, nthr);
    float* sg = buf + 2 * tbc * lay.SE;
    g_units(ch, [&](int off, long long first, int count, int u) {
      gpar::unit_in(sg + off, g, first, count, n * D * C, u);
    });
    __pipeline_commit();
  };

  auto store = [&](int ch) {
    const float* buf = buffer(ch);
    auto chunk = [&](int j, long long& k0) { return rows_of(j, ch, k0); };
    if (mat) gpar::ranges_out<DD, R3Smem<D>::SE>(M_out, buf + tbc * lay.SE, tbc, chunk, tid, nthr);
    const float* sg = buf + 2 * tbc * lay.SE;
    g_units(ch, [&](int off, long long first, int count, int u) {
      gpar::unit_out(v_out, sg + off, first, count, u);
    });
  };

  // Column threads, then the matrix warp (lane jm).
  const int col_threads = (tbc * bt + 31) / 32 * 32;
  const int j = tid / bt, col = tid % bt;
  const bool is_col = tid < tbc * bt && col < ncols && tb0 + j < nblocks;
  const int jm = tid - col_threads;
  const bool is_mat = mat && jm >= 0 && jm < tbc && tb0 + jm < nblocks;

  float v[D], Ms[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    v[i] = is_col ? g0[((tb0 + j) * D + i) * C + c0 + col] : 0.0f;
#pragma unroll
    for (int l = 0; l < D; ++l) Ms[i][l] = is_mat ? L0[((tb0 + jm) * D + i) * D + l] : 0.0f;
  }

  const int nch = s_nch;
  if (nch > 0) stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    float* buf = buffer(ch);
    if (is_col) {  // [K4b column threads]
      long long k0;
      const int rows = rows_of(j, ch, k0);
      const float* e = buf + j * lay.SE + gpar::lead(k0 * DD);
      float* gs = buf + 2 * tbc * lay.SE + j * lay.SG();
      for (int t = rows - 1; t >= 0; --t) {
        float* gt[D];  // row (t, i) of g in, v out, at this thread's column
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const int q = t * D + i;
          gt[i] = whole ? gs + gpar::lead(k0 * D * C) + q * C + col
                        : gs + q * lay.gseg + gpar::lead(g_first(k0, q)) + col;
        }
        float out[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = *gt[i];
#pragma unroll
          for (int l = 0; l < D; ++l) s += e[t * DD + i * D + l] * v[l];
          out[i] = s;
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
          v[i] = out[i];
          *gt[i] = out[i];
        }
      }
    } else if (is_mat) {  // [K4b matrix warp]
      long long k0;
      const int rows = rows_of(jm, ch, k0);
      const float* e = buf + jm * lay.SE + gpar::lead(k0 * DD);
      float* lm = buf + (tbc + jm) * lay.SE + gpar::lead(k0 * DD);  // L in, M out
      for (int t = rows - 1; t >= 0; --t) {
        float Ek[D][D], Lk[D][D];
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int l = 0; l < D; ++l) {
            Ek[i][l] = e[t * DD + i * D + l];
            Lk[i][l] = lm[t * DD + i * D + l];
          }
        congruence<D>(Ek, Lk, Ms);
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int l = 0; l < D; ++l) lm[t * DD + i * D + l] = Ms[i][l];
      }
    }  // [end K4b threads]
    __syncthreads();
    store(ch);  // [K4b stores]
    __syncthreads();
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
  if (n < 1 || T < 1 || nblocks < 1 || C < 1 || static_cast<long long>(nblocks) * T < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!gpar::aligned16({E, g, L, v_out, M_out})) return static_cast<int>(cudaErrorMisalignedAddress);
  const int bt = min(C, kColTile);
  const int tbc = max(1, min(kMaxTB, kColThreads / bt));
  const dim3 grid((nblocks + tbc - 1) / tbc, (C + bt - 1) / bt);
  // column warps, the matrix warp, and warps that only stage and store up
  // to 8 warps
  const int threads = max(256, (tbc * bt + 31) / 32 * 32 + 32);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // Chunks aligned to the series where a chunk's g rows are short (C = 1:
  // 24 floats at d = 3), so that their seams would split sectors; at
  // C = 33 (792 floats) the extra chunk per time block costs more than the
  // whole sectors save (tools/k2_k4b_step_split.py, "series-aligned").
  const bool aligned = kChunk * d * C <= 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPAR_R3(DD)                                                                          \
  {                                                                                          \
    const int smem = static_cast<int>(sizeof(float)) * R3Smem<DD>(C, tbc, bt).floats();      \
    const cudaError_t e = cudaFuncSetAttribute(                                              \
        suffix_replay_kernel<DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);        \
    if (e != cudaSuccess) return static_cast<int>(e);                                        \
    suffix_replay_kernel<DD><<<grid, threads, smem, s>>>(                                    \
        static_cast<const float*>(E), static_cast<const float*>(g),                          \
        static_cast<const float*>(L), n, T, nblocks, C, tbc, bt, aligned,                    \
        static_cast<const float*>(g0), static_cast<const float*>(L0),                        \
        static_cast<float*>(v_out), static_cast<float*>(M_out));                             \
  }
  switch (d) {
    case 1: GPAR_R3(1); break;
    case 2: GPAR_R3(2); break;
    case 3: GPAR_R3(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPAR_R3
  return static_cast<int>(cudaGetLastError());
}
