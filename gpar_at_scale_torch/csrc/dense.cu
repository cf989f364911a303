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
// What bounds them on this card: latency and shared memory, not device
// memory or operations.  At (n, k) = (256, 413) K6a's work is 5.6 MFLOP of
// Cholesky and 27 MFLOP of solve (0.5 us at the float32 rate) and 1.4 MB of
// traffic (0.4 us at 3.35 TB/s), but the factorization is a chain of n
// dependent pivots, each behind a barrier, on one SM per matrix; an
// L2-resident trailing matrix adds a round trip per panel, and a
// right-hand side walked tile by tile on that SM adds its tiles' time.
//
// Design of K6a (chol_solve_kernel) for n up to about 280, every EEG shape:
//   * the matrix's upper triangle (n (n + 1) / 2 floats and a little
//     padding, 133 KB at n = 256) and one 64-column tile of the right-hand
//     side (65.5 KB) stay in shared memory, so nothing touches device
//     memory between the load and the store;
//   * the grid is (1, ceil(k / 64), batch): each block factors its matrix
//     redundantly and solves its own tile, so the tiles run side by side on
//     as many SMs (the pivot chain is latency: repeating it costs no time
//     while SMs are free); block y = 0 writes U, logdet and info; k = 0 runs
//     one block;
//   * the right-hand side is treated as more columns of the matrix, W = U^-T
//     B being the upper-right block of the factor of [S B; B^T *].  Per
//     panel of kNB = 16 rows: (1) one warp factors the 16 x 16 diagonal
//     block, a lane per column held in registers, the pivot rows passed by
//     shuffles; (2) every thread takes one later column of the panel's
//     rows (matrix or right-hand side) through the 16-step forward
//     substitution in registers; (3) the rank-16 update of the trailing
//     triangle and of the right-hand side's later rows, a warp per 32 x 64
//     tile, each thread accumulating an 8 x 8 register tile from 16-byte
//     shared loads (4 loads per 64 FMAs; the triangle's rows start on
//     16-byte boundaries for it).  Three block barriers per panel instead
//     of one per pivot.
// Above that (n <= 512), where the triangle does not fit, chol_solve_l2_kernel:
// one block per matrix, the trailing matrix in device memory (L2), 16-row
// panels in shared memory, the right-hand side in 64-column tiles.
//
// Design of K6b and K6c (tri_kernel), one kernel for every n <= 512.  Their
// work is n^2 k FLOP on 4 (n^2 / 2 + 2 n k) bytes, 0.3 MB at the EEG shapes:
// the time is the latency of n / 16 dependent panels, not bandwidth.
//   * a block owns a tile of kTriKT = 16 columns of one matrix's right-hand
//     side on a (ceil(k / 16), batch) grid; the tile (n x 16 floats) is
//     copied into shared memory once by cp.async and written back once at
//     the end, so nothing touches device memory on X between panels;
//   * the coefficients of panel p + 1 (16 pivots against every equation
//     they reach) are copied by cp.async into the other half of a
//     two-stage ring while panel p is solved: K6b's pivots are 16 rows of U
//     (16-byte copies where rows allow them), K6c's a strip of 16 of its
//     columns (4-byte copies, transposed on the way in);
//   * per panel: (1) 16 threads take one column each through the 16-step
//     substitution in registers, right-looking (each solved pivot at once
//     subtracted from the panel's later ones), coefficients and
//     right-hand side read from shared memory; (2) the rank-16 update of
//     the tile's rows that the panel reaches, a 4 x 4 register tile per
//     thread from 16-byte shared loads (a warp's coefficient and
//     right-hand-side loads are one wavefront each).  Two block barriers
//     per panel.  The reciprocals of the diagonal are taken once, up front.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry
// returns cudaGetLastError() after the launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNB = 16;        // panel rows
constexpr int kKT = 64;        // right-hand-side columns per tile
constexpr int kThreads = 512;
constexpr int kNMax = 512;
constexpr int kGroups = kThreads / kKT;  // row groups of an update
constexpr int kBatch = 8;                // rows whose loads are in flight at once
constexpr float kTiny = 1e-30f;
// Dynamic shared memory a block may hold: 227 KB less chol_solve_kernel's
// static arrays.
constexpr size_t kSmemMax = 232448 - 6144;
constexpr int kRThreads = 256;  // threads of chol_solve_kernel

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

// Step 1 of tri_kernel and of solve_panel, for one column: the panel's nbp
// pivots, x_j = e[j * ldx], solved in place in registers, right-looking;
// c[q * ldc + j] is the coefficient of pivot q in pivot j's equation, inv[j]
// the reciprocal of pivot j's diagonal.  kFull (nbp = kNB) drops the guards on nbp, which
// would otherwise cut the chain of dependent steps into branches.
template <bool kForward, bool kFull>
__device__ __forceinline__ void solve_pivots(float* e, int ldx, const float* __restrict__ c,
                                             int ldc, const float* __restrict__ inv, int nbp) {
  float s[kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) s[j] = (kFull || j < nbp) ? e[j * ldx] : 0.0f;
#pragma unroll
  for (int i = 0; i < kNB; ++i) {
    const int q = kForward ? i : kNB - 1 - i;
    if (kFull || q < nbp) {
      const float x = s[q] * inv[q];
      s[q] = x;
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        if ((kForward ? j > q : j < q) && (kFull || j < nbp)) s[j] -= c[q * ldc + j] * x;
    }
  }
#pragma unroll
  for (int j = 0; j < kNB; ++j)
    if (kFull || j < nbp) e[j * ldx] = s[j];
}

// Step 2 of chol_solve_l2_kernel for one panel: solve the panel's kNB
// pivots (rows r0 .. r0 + nbp - 1) in the right-hand side X (n x k,
// row-major, columns [c_begin, c_end)), then update every later row
// r0 + nbp .. n - 1.  Ps[q * n + j] is the coefficient of pivot q of the
// panel in equation j; invd[q] the reciprocal of pivot q's diagonal.  The
// pivots are solved right-looking, as tri_kernel's are.  Xs is a kNB x kKT
// scratch tile.  Ends with a barrier.
__device__ __forceinline__ void solve_panel(const float* __restrict__ Ps,
                                            const float* __restrict__ invd, int r0, int nbp,
                                            int n, float* __restrict__ X, int k, int c_begin,
                                            int c_end, float* __restrict__ Xs) {
  for (int c0 = c_begin; c0 < c_end; c0 += kKT) {
    const int cw = min(kKT, c_end - c0);
    if (threadIdx.x < cw) {
      float* e = X + static_cast<long long>(r0) * k + c0 + threadIdx.x;
      if (nbp == kNB)
        solve_pivots<true, true>(e, k, Ps + r0, n, invd, kNB);
      else
        solve_pivots<true, false>(e, k, Ps + r0, n, invd, nbp);
      for (int jj = 0; jj < nbp; ++jj) Xs[jj * kKT + threadIdx.x] = e[static_cast<long long>(jj) * k];
    }
    __syncthreads();
    update_rows<false>(Ps, nbp, n, Xs, kKT, X, k, r0 + nbp, n, c0, cw);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
chol_solve_l2_kernel(const float* __restrict__ S, const float* __restrict__ B, int n, int k,
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
    solve_panel(Up, invd, r0, nbp, n, W, k, 0, k, Xs);

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

// chol_solve_kernel's layout in shared memory.  Row i of the upper
// triangle is stored from column 4 floor(i / 4), rows padded to a multiple
// of 4 floats, so that every row starts on a 16-byte boundary and the
// rank-16 update reads 4 neighbouring floats at once; element (i, l >= i)
// sits at tri_base(i) + l.  Rows 4m .. 4m + 3 hold n4 - 4m floats each
// (n4 = n rounded up to 4).  The right-hand-side tile follows, n rows of
// kt4 floats (kt rounded up to 4).
__host__ __device__ inline int tri_base(int i, int n4) {
  const int m = i >> 2, r = i & 3;
  return 4 * n4 * m - 8 * m * (m - 1) + r * (n4 - 4 * m) - 4 * m;
}

__host__ __device__ inline size_t tri_floats(int n) {
  const int n4 = (n + 3) & ~3;
  return static_cast<size_t>(tri_base(n, n4) + 4 * (n >> 2));  // the start of row n
}

__host__ __device__ inline size_t resident_smem(int n, int kt) {
  return sizeof(float) * (tri_floats(n) + static_cast<size_t>(n) * ((kt + 3) & ~3));
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// K6a with the matrix resident in shared memory (see the design note).
__global__ void __launch_bounds__(kRThreads)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ B, int n, int k,
                  float* __restrict__ U, float* __restrict__ W, float* __restrict__ logdet,
                  int* __restrict__ info) {
  extern __shared__ float4 smem4[];
  __shared__ float invd[kNB];
  __shared__ float Dg[kNB][kNB + 1];  // the panel's diagonal block of U
  __shared__ double ldv[kNMax];       // the clamped diagonal of U, then its logs
  const int c0 = blockIdx.y * kKT;
  const int kt = min(kKT, k - c0);  // 0 when k = 0
  const int kt4 = (kt + 3) & ~3, n4 = (n + 3) & ~3;
  float* A = reinterpret_cast<float*>(smem4);
  float* X = A + tri_floats(n);  // X[i * kt4 + c]

  const long long b = blockIdx.z;
  S += b * n * n;
  U += b * n * n;
  B += b * n * k;
  W += b * n * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kRThreads / 32;
  constexpr int kInFlight = 8;  // loads each thread keeps in flight
  constexpr unsigned kAll = 0xffffffffu;

  // S's upper triangle, in 16-byte loads where rows allow them
  if (n % 4 == 0 && reinterpret_cast<size_t>(S) % 16 == 0) {
    const float4* S4 = reinterpret_cast<const float4*>(S);
    const int nv = n * n / 4;
    for (int v0 = tid; v0 < nv; v0 += kRThreads * kInFlight) {
      float4 q[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (v0 + u * kRThreads < nv) q[u] = S4[v0 + u * kRThreads];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int v = v0 + u * kRThreads;
        if (v < nv) {
          const int i = 4 * v / n, l = 4 * v % n;
          const float e[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (l + c >= i) A[tri_base(i, n4) + l + c] = e[c];
        }
      }
    }
  } else {
    for (int e0 = tid; e0 < n * n; e0 += kRThreads * kInFlight) {
      float q[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (e0 + u * kRThreads < n * n) q[u] = S[e0 + u * kRThreads];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = e0 + u * kRThreads, i = e / n, l = e % n;
        if (e < n * n && l >= i) A[tri_base(i, n4) + l] = q[u];
      }
    }
  }
  for (int e0 = tid; e0 < n * kt; e0 += kRThreads * kInFlight) {
    float q[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kRThreads;
      if (e < n * kt) q[u] = B[static_cast<long long>(e / kt) * k + c0 + e % kt];
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kRThreads;
      if (e < n * kt) X[(e / kt) * kt4 + e % kt] = q[u];
    }
  }
  __syncthreads();

  int bad = 0;  // warp 0
  for (int r0 = 0; r0 < n; r0 += kNB) {
    const int nbp = min(kNB, n - r0);
    const int t0 = r0 + nbp, w = n - t0;

    // 1. the diagonal block, one warp: lane l holds column r0 + l in
    //    registers, shifted up one row per pivot; each pivot is passed on
    //    by one shuffle from the lane that owns it, the row of U by
    //    shuffles off that chain.
    if (warp == 0) {
      float col[kNB];  // col[i]: element (r0 + jj + i, r0 + lane) at pivot jj
#pragma unroll
      for (int ii = 0; ii < kNB; ++ii)
        col[ii] = (lane < nbp && ii <= lane) ? A[tri_base(r0 + ii, n4) + r0 + lane] : 0.0f;
      float my_inv = 0.0f, my_pivot = 1.0f;  // lane l's own pivot, l < nbp
      float pivot = __shfl_sync(kAll, col[0], 0);
#pragma unroll 1
      for (int jj = 0; jj < nbp; ++jj) {
        const float inv = rsqrtf(fmaxf(pivot, kTiny));
        if (lane == jj) {
          my_inv = inv;
          my_pivot = pivot;
        }
        const float u = col[0] * inv;  // U(r0 + jj, r0 + lane) for lane >= jj
        if (lane >= jj && lane < nbp) {
          A[tri_base(r0 + jj, n4) + r0 + lane] = u;
          Dg[jj][lane] = u;
        }
        // lane jj + 1's own update of its diagonal: the next pivot
        pivot = __shfl_sync(kAll, __fmaf_rn(-u, u, col[1]), jj + 1);
#pragma unroll
        for (int i = 1; i < kNB; ++i) {
          const float cf = __shfl_sync(kAll, u, jj + i);  // U(r0 + jj, r0 + jj + i)
          if (jj + i < nbp && lane >= jj + i) col[i] = __fmaf_rn(-cf, u, col[i]);
        }
#pragma unroll
        for (int i = 0; i + 1 < kNB; ++i) col[i] = col[i + 1];
        col[kNB - 1] = 0.0f;
      }
      const unsigned nonpos = __ballot_sync(kAll, lane < nbp && !(my_pivot > 0.0f));
      if (bad == 0 && nonpos != 0) bad = r0 + __ffs(nonpos);
      if (lane < nbp) {
        invd[lane] = my_inv;
        ldv[r0 + lane] = static_cast<double>(fmaxf(my_pivot * my_inv, kTiny));
      }
    }
    __syncthreads();

    // 2. the panel's rows in the later columns (t0 .. n - 1) and in the
    //    right-hand side: a forward substitution per column, in registers
    for (int cidx = tid; cidx < w + kt; cidx += kRThreads) {
      const bool rhs = cidx >= w;
      float* e = rhs ? X + r0 * kt4 + cidx - w : A + t0 + cidx;
      float s[kNB];
#pragma unroll
      for (int jj = 0; jj < kNB; ++jj)
        if (jj < nbp) s[jj] = rhs ? e[jj * kt4] : e[tri_base(r0 + jj, n4)];
#pragma unroll
      for (int q = 0; q < kNB; ++q) {
        if (q < nbp) {
          const float x = s[q] * invd[q];
          s[q] = x;
#pragma unroll
          for (int jj = q + 1; jj < kNB; ++jj)
            if (jj < nbp) s[jj] -= Dg[q][jj] * x;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kNB; ++jj) {
        if (jj < nbp) {
          if (rhs)
            e[jj * kt4] = s[jj];
          else
            e[tri_base(r0 + jj, n4)] = s[jj];
        }
      }
    }
    __syncthreads();

    // 3. rank-nbp update of the trailing triangle and of the right-hand
    //    side's rows t0 .. n - 1: a warp per 32 x 64 tile, lane (ty, tx) on
    //    rows i0 .. i0 + 7 and columns lc .. lc + 3 and lc + 32 .. lc + 35,
    //    every operand read as 16 bytes (values past the edge come from the
    //    padding or the next row and are never stored), the tile read and
    //    written back as 16 bytes where it lies inside the triangle.  Shared
    //    memory's bandwidth is the limit here: 16 loads per 64 FMAs.  Only
    //    tiles that reach the upper triangle are dealt out: column group cg
    //    of the matrix has min(nrg, 2 cg + 2) of them, then come the
    //    right-hand side's nrg.
    const int tx = lane & 7, ty = lane >> 3;
    const int nrg = (w + 31) / 32, ncm = (w + 63) / 64;
    int ntiles = kt > 0 ? nrg : 0;
    for (int cg = 0; cg < ncm; ++cg) ntiles += min(nrg, 2 * cg + 2);
    for (int tile = warp; tile < ntiles; tile += kWarps) {
      int rg = tile, cg = 0;
      while (cg < ncm && rg >= min(nrg, 2 * cg + 2)) rg -= min(nrg, 2 * cg++ + 2);
      const bool rhs = cg == ncm;
      const int i0 = t0 + 32 * rg + 8 * ty;
      const int lc = (rhs ? 0 : t0 + 64 * cg) + 4 * tx;
      const int cap = rhs ? kt4 : n4;  // columns a row holds
      const bool a_lo = i0 + 4 <= n4, a_hi = i0 + 8 <= n4;
      const bool b_lo = lc + 4 <= cap, b_hi = lc + 36 <= cap;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
      for (int q = 0; q < nbp; ++q) {
        const float* urow = A + tri_base(r0 + q, n4);
        const float* brow = rhs ? X + (r0 + q) * kt4 : urow;
        const float4 alo = a_lo ? lds4(urow + i0) : zero;
        const float4 ahi = a_hi ? lds4(urow + i0 + 4) : zero;
        const float4 blo = b_lo ? lds4(brow + lc) : zero;
        const float4 bhi = b_hi ? lds4(brow + lc + 32) : zero;
        const float a[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
        const float bv[8] = {blo.x, blo.y, blo.z, blo.w, bhi.x, bhi.y, bhi.z, bhi.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] += a[r] * bv[c];
      }
      const int lim = rhs ? kt : n;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + r;
        if (i >= n) continue;
        float* row = rhs ? X + i * kt4 : A + tri_base(i, n4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = lc + 32 * h;
          if (l + 3 < lim && (rhs || l >= i)) {
            float4 v = lds4(row + l);
            v.x -= acc[r][4 * h];
            v.y -= acc[r][4 * h + 1];
            v.z -= acc[r][4 * h + 2];
            v.w -= acc[r][4 * h + 3];
            *reinterpret_cast<float4*>(row + l) = v;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (l + c < lim && (rhs || l + c >= i)) row[l + c] -= acc[r][4 * h + c];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = warp; i < n; i += kWarps) {
    if (blockIdx.y == 0)
      for (int l = lane; l < n; l += 32)
        U[static_cast<long long>(i) * n + l] = l >= i ? A[tri_base(i, n4) + l] : 0.0f;
    for (int c = lane; c < kt; c += 32) W[static_cast<long long>(i) * k + c0 + c] = X[i * kt4 + c];
  }
  if (blockIdx.y == 0) {
    // logdet: the logs in parallel, their sum in row order
    for (int i = tid; i < n; i += kRThreads) ldv[i] = log(ldv[i]);
    __syncthreads();
    if (tid == 0) {
      double ld = 0.0;
      for (int i = 0; i < n; ++i) ld += ldv[i];
      logdet[b] = static_cast<float>(2.0 * ld);
      info[b] = bad;
    }
  }
}

constexpr int kTriThreads = 256;  // threads of tri_kernel
// Right-hand-side columns per tri_kernel block: the narrowest tile whose
// rows the update's 4 x 4 register tiles read as 16 bytes, and the one that
// spreads a matrix's columns over the most SMs (k = 157 over 10); 32 and 64
// were slower at every shape swept (tools/k6bc_step_split.py).
constexpr int kTriKT = 16;

// tri_kernel's layout in shared memory, in floats: the right-hand-side
// tile (n4 rows of kTriKT), two stages of kNB coefficient rows of tri_ld(n)
// (rows 16-byte aligned; the stride is 4 more than a multiple of 32, so a
// strip of 16 columns copied in transposed lands on 8 bank groups), and
// the reciprocals of the diagonal.
__host__ __device__ inline int tri_ld(int n) { return ((n + 31) & ~31) + 4; }

__host__ __device__ inline size_t tri_smem(int n) {
  const int n4 = (n + 3) & ~3;
  return sizeof(float) * (static_cast<size_t>(n4) * kTriKT + 2 * kNB * tri_ld(n) + n4);
}

// K6b (kForward: X = U^-T B, pivots from the first row) and K6c (X = U^-1 B,
// from the last), see the design note.  Stage element Ps[q * ld + j] is the
// coefficient of the panel's pivot q in equation j: U[r0 + q, j] for K6b (a
// row of U) and U[j, r0 + q] for K6c (a column).
template <bool kForward>
__global__ void __launch_bounds__(kTriThreads)
tri_kernel(const float* __restrict__ U, const float* __restrict__ B, int n, int k,
           float* __restrict__ X) {
  extern __shared__ float4 smem4[];
  constexpr int KT = kTriKT, CG = KT / 4;  // columns and 4-column groups of the tile
  const int n4 = (n + 3) & ~3, ld = tri_ld(n);
  float* Xt = reinterpret_cast<float*>(smem4);  // Xt[i * KT + c]
  float* stage = Xt + n4 * KT;                  // two stages of kNB x ld
  float* invd = stage + 2 * kNB * ld;

  const long long b = blockIdx.y;
  U += b * n * n;
  B += b * n * k;
  X += b * n * k;
  const int c0 = blockIdx.x * KT, kw = min(KT, k - c0);
  const int tid = threadIdx.x;
  const bool vec_u = n % 4 == 0 && reinterpret_cast<size_t>(U) % 16 == 0;
  const bool vec_b = k % 4 == 0 && reinterpret_cast<size_t>(B) % 16 == 0;
  const int npanels = (n + kNB - 1) / kNB;

  // panel p: pivots r0 .. r0 + nbp - 1; K6b's run up from the first row,
  // K6c's down from the last, the ragged panel at the top
  auto panel = [&](int p, int& r0, int& nbp) {
    if (kForward) {
      r0 = p * kNB;
      nbp = min(kNB, n - r0);
    } else {
      const int e = n - p * kNB;
      r0 = max(0, e - kNB);
      nbp = e - r0;
    }
  };
  // Copy panel p's coefficients into stage s: equations [jb, je), the ones
  // the panel's pivots reach (K6b: r0 .. n - 1, K6c: 0 .. r0 + nbp - 1).
  auto load_panel = [&](int p, int s) {
    int r0, nbp;
    panel(p, r0, nbp);
    const int jb = kForward ? r0 : 0, je = kForward ? n : r0 + nbp;
    float* Ps = stage + s * kNB * ld;
    if (kForward) {  // pivot q's coefficients are U's row r0 + q
      // (spread over every thread: copies queued on the warp that solves
      // the pivots next hold it up)
      if (vec_u) {  // jb and je are multiples of 4 here
        const int w4 = (je - jb) / 4;
        for (int idx = tid; idx < nbp * w4; idx += kTriThreads) {
          const int q = idx / w4, j = jb + 4 * (idx - q * w4);
          __pipeline_memcpy_async(Ps + q * ld + j, U + static_cast<long long>(r0 + q) * n + j, 16);
        }
      } else {
        const int w = je - jb;
        for (int idx = tid; idx < nbp * w; idx += kTriThreads) {
          const int q = idx / w, j = jb + idx - q * w;
          __pipeline_memcpy_async(Ps + q * ld + j, U + static_cast<long long>(r0 + q) * n + j, 4);
        }
      }
    } else {  // they are U's column r0 + q: 16 floats of each row j, transposed
      for (int idx = tid; idx < (je - jb) * kNB; idx += kTriThreads) {
        const int j = jb + idx / kNB, q = idx % kNB;
        if (q < nbp)
          __pipeline_memcpy_async(Ps + q * ld + j, U + static_cast<long long>(j) * n + r0 + q, 4);
      }
    }
  };

  // the tile (columns past k are zero) and panel 0, one commit group
  if (vec_b) {
    for (int idx = tid; idx < n * CG; idx += kTriThreads) {
      const int i = idx / CG, c = 4 * (idx % CG);
      float* dst = Xt + i * KT + c;
      if (c < kw)
        __pipeline_memcpy_async(dst, B + static_cast<long long>(i) * k + c0 + c, 16);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int idx = tid; idx < n * KT; idx += kTriThreads) {
      const int i = idx / KT, c = idx % KT;
      if (c < kw)
        __pipeline_memcpy_async(Xt + idx, B + static_cast<long long>(i) * k + c0 + c, 4);
      else
        Xt[idx] = 0.0f;
    }
  }
  load_panel(0, 0);
  __pipeline_commit();
  for (int j = tid; j < n; j += kTriThreads) invd[j] = 1.0f / U[static_cast<long long>(j) * n + j];

  for (int p = 0; p < npanels; ++p) {
    __pipeline_wait_prior(0);
    __syncthreads();  // panel p is in, and the previous update is done
    if (p + 1 < npanels) load_panel(p + 1, (p + 1) & 1);
    __pipeline_commit();
    int r0, nbp;
    panel(p, r0, nbp);
    const float* Ps = stage + (p & 1) * kNB * ld;

    // 1. the panel's pivots, one column of the tile per thread
    if (tid < KT) {
      if (nbp == kNB)
        solve_pivots<kForward, true>(Xt + r0 * KT + tid, KT, Ps + r0, ld, invd + r0, kNB);
      else
        solve_pivots<kForward, false>(Xt + r0 * KT + tid, KT, Ps + r0, ld, invd + r0, nbp);
    }
    __syncthreads();

    // 2. rank-16 update of rows [lo, hi): thread t takes rows i0 .. i0 + 3
    //    and columns 4 cg .. 4 cg + 3; rows past hi are computed from
    //    padding and not stored.  Only the last panel can be ragged, and it
    //    reaches no rows, so every update takes kNB pivots.
    const int lo = kForward ? r0 + nbp : 0, hi = kForward ? n : r0;
    const int ntiles = (hi - lo + 3) / 4 * CG;
    for (int t = tid; t < ntiles; t += kTriThreads) {
      const int cg = t % CG, i0 = lo + 4 * (t / CG);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll
      for (int q = 0; q < kNB; ++q) {
        const float4 a4 = lds4(Ps + q * ld + i0);
        const float4 b4 = lds4(Xt + (r0 + q) * KT + 4 * cg);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * bv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r < hi) {
          float4* row = reinterpret_cast<float4*>(Xt + (i0 + r) * KT + 4 * cg);
          float4 v = *row;
          v.x -= acc[r][0];
          v.y -= acc[r][1];
          v.z -= acc[r][2];
          v.w -= acc[r][3];
          *row = v;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n * KT; idx += kTriThreads) {
    const int i = idx / KT, c = idx % KT;
    if (c < kw) X[static_cast<long long>(i) * k + c0 + c] = Xt[idx];
  }
}

}  // namespace

extern "C" int dense_chol_solve(const void* S, const void* B, int n, int k, int batch, void* U,
                                void* W, void* logdet, void* info, void* stream) {
  if (n < 1 || n > kNMax || k < 0 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s_ = static_cast<const float*>(S);
  const float* b_ = static_cast<const float*>(B);
  float* u_ = static_cast<float*>(U);
  float* w_ = static_cast<float*>(W);
  float* ld_ = static_cast<float*>(logdet);
  int* info_ = static_cast<int*>(info);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (k + kKT - 1) / kKT;
  const size_t resident = resident_smem(n, min(k, kKT));
  if (resident <= kSmemMax && tiles <= 65535) {
    cudaError_t e = cudaFuncSetAttribute(chol_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(resident));
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_solve_kernel<<<dim3(1, tiles > 0 ? tiles : 1, batch), kRThreads, resident, st>>>(
        s_, b_, n, k, u_, w_, ld_, info_);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * (2 * kNB * n + kNB * kKT);
  cudaError_t e = cudaFuncSetAttribute(chol_solve_l2_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_solve_l2_kernel<<<dim3(1, 1, batch), kThreads, smem, st>>>(s_, b_, n, k, u_, w_, ld_,
                                                                  info_);
  return static_cast<int>(cudaGetLastError());
}

template <bool kForward>
static int launch_tri(const void* U, const void* B, int n, int k, int batch, void* X,
                      void* stream) {
  if (n < 1 || n > kNMax || k < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tri_smem(n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tri_kernel<kForward>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tri_kernel<kForward><<<dim3((k + kTriKT - 1) / kTriKT, batch), kTriThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
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
