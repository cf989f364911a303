#!/usr/bin/env python3
"""Split K1's time on the card by leaving parts of it out.

    python3 tools/k1_step_split.py [--root DIR] [--reps 50] [--seed 0]

Builds variants of ``phase1_kernel`` (``csrc/kalman_scan.cu``) of the
checkout DIR (default: the one holding this script) with nvcc, and times
each with CUDA events, calling the C entry directly, on the chain's first
conditional (``chip_smoke.scan_inputs``: N = 1e6, d = 3, 16384 blocks of 62
steps, made from ``--seed``).  Variants:

* "no steps" leaves out the filter's steps (the rows are still staged and
  the element stored), "no stores" the store of the block element (its
  value is still computed), "loads only" both; "direct stores" stores
  each lane's element straight to device memory instead of through
  shared memory as 16-byte units;
* "combine" folds each step's one-step filtering element into the running
  element with the general combine (two d x d inverses a step), the fold
  the kernel's affine recursion replaces, on the same staging;
* "chunk 4" and "chunk 16" stage 4 or 16 steps at a time instead of 8;
  "1 copy warp", "3 copy warps" and "7 copy warps" give each CUDA block
  2, 4 or 8 warps (the warps beside the one that runs the steps only copy;
  the kernel's own count is "full" and is not built again).

A variant that leaves a part out gives wrong results; only its time is
read.  The variants that compute the element print their largest relative
difference from K1's plain version beside their time.  It also prints the
SM clock measured by a kernel spinning on clock64(), beside nvidia-smi's.
Needs a CUDA device and nvcc; writes its builds under build/k1_step_split/.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.chip_timing import (  # noqa: E402
    build_variants,
    event_ms,
    patch_source,
    print_clocks,
    this_chip_smoke,
)

# Switches put in front of the source: each part is on unless its variant
# defines the switch as 1.
_PRELUDE = "".join(f"#ifndef {k}\n#define {k} {v}\n#endif\n" for k, v in (
    ("NO_STEPS", 0), ("NO_STORES", 0), ("COMBINE", 0), ("DIRECT_STORES", 0)))

# The fold K1's recursion replaces: one-step filtering elements (H = e1)
# and the general combine, inserted in front of the kernel.
_COMBINE_DEFS = r'''
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

// r <- r o e  (r earlier, e later)
template <int D>
__device__ __forceinline__ void combine(Elem<D>& r, const Elem<D>& e) {
  float Z[D][D], Zi[D][D], AjZ[D][D], A_new[D][D], T1[D][D];
  matmul<D>(r.C, e.J, Z);
  for (int i = 0; i < D; ++i) Z[i][i] += 1.0f;
  inv_small<D>(Z, Zi);
  matmul<D>(e.A, Zi, AjZ);
  matmul<D>(AjZ, r.A, A_new);
  float tmp[D], b_new[D];
  for (int i = 0; i < D; ++i) {
    float s = r.b[i];
    for (int k = 0; k < D; ++k) s += r.C[i][k] * e.eta[k];
    tmp[i] = s;
  }
  for (int i = 0; i < D; ++i) {
    float s = e.b[i];
    for (int k = 0; k < D; ++k) s += AjZ[i][k] * tmp[k];
    b_new[i] = s;
  }
  float C_new[D][D];
  matmul<D>(AjZ, r.C, T1);
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      float s = e.C[i][j];
      for (int k = 0; k < D; ++k) s += T1[i][k] * e.A[j][k];
      C_new[i][j] = s;
    }
  float Z2[D][D], Z2i[D][D], AiTZ2[D][D];
  matmul<D>(e.J, r.C, Z2);
  for (int i = 0; i < D; ++i) Z2[i][i] += 1.0f;
  inv_small<D>(Z2, Z2i);
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      float s = 0.0f;
      for (int k = 0; k < D; ++k) s += r.A[k][i] * Z2i[k][j];
      AiTZ2[i][j] = s;
    }
  float eta_new[D];
  for (int i = 0; i < D; ++i) {
    float s = e.eta[i];
    for (int k = 0; k < D; ++k) s -= e.J[i][k] * r.b[k];
    tmp[i] = s;
  }
  for (int i = 0; i < D; ++i) {
    float s = r.eta[i];
    for (int k = 0; k < D; ++k) s += AiTZ2[i][k] * tmp[k];
    eta_new[i] = s;
  }
  float J_new[D][D];
  matmul<D>(AiTZ2, e.J, T1);
  for (int i = 0; i < D; ++i)
    for (int j = 0; j < D; ++j) {
      float s = r.J[i][j];
      for (int k = 0; k < D; ++k) s += T1[i][k] * r.A[k][j];
      J_new[i][j] = s;
    }
  for (int i = 0; i < D; ++i) {
    r.b[i] = b_new[i];
    r.eta[i] = eta_new[i];
    for (int j = 0; j < D; ++j) {
      r.A[i][j] = A_new[i][j];
      r.C[i][j] = C_new[i][j];
      r.J[i][j] = J_new[i][j];
    }
  }
}

'''

# The step as the combine fold: the one-step element of (A_k, Q_k, R_k, y_k)
# folded into the running element (Ar, br, Cr, er, Jr).
_COMBINE_STEP = r'''      {
        float Ak[D][D], Qk[D][D], K[D];
        for (int i = 0; i < D; ++i)
          for (int j = 0; j < D; ++j) {
            Ak[i][j] = a[t * DD + i * D + j];
            Qk[i][j] = q[t * DD + i * D + j];
          }
        const float S = Qk[0][0] + rr[t], yk = yy[t];
        for (int i = 0; i < D; ++i) K[i] = Qk[i][0] / S;
        Elem<D> e, r;
        for (int i = 0; i < D; ++i) {
          e.b[i] = K[i] * yk;
          e.eta[i] = Ak[0][i] * (yk / S);
          r.b[i] = br[i];
          r.eta[i] = er[i];
          for (int j = 0; j < D; ++j) {
            e.A[i][j] = Ak[i][j] - K[i] * Ak[0][j];
            e.C[i][j] = Qk[i][j] - K[i] * Qk[0][j];
            e.J[i][j] = Ak[0][i] * Ak[0][j] / S;
            r.A[i][j] = Ar[i][j];
            r.C[i][j] = Cr[i][j];
            r.J[i][j] = Jr[i][j];
          }
        }
        combine<D>(r, e);
        for (int i = 0; i < D; ++i) {
          br[i] = r.b[i];
          er[i] = r.eta[i];
          for (int j = 0; j < D; ++j) {
            Ar[i][j] = r.A[i][j];
            Cr[i][j] = r.C[i][j];
            Jr[i][j] = r.J[i][j];
          }
        }
      }
'''

# "no stores": the element is not stored, but kept live by a store that
# happens only if it sums to a value never computed.
_KEEP = r'''  {
    float keep = 0.0f;
    for (int i = 0; i < D; ++i) {
      keep += br[i] + er[i];
      for (int j = 0; j < D; ++j) keep += Ar[i][j] + Cr[i][j] + Jr[i][j];
    }
    if (keep == 1.2345e-30f) eA[0] = keep;
  }
'''

# "direct stores": each lane stores its element straight to device memory.
_DIRECT = r'''  if (tid < NB && blk < nblocks) {
    for (int i = 0; i < D; ++i) {
      eb[blk * D + i] = br[i];
      eeta[blk * D + i] = er[i];
      for (int j = 0; j < D; ++j) {
        eA[(blk * D + i) * D + j] = Ar[i][j];
        eC[(blk * D + i) * D + j] = Cr[i][j];
        eJ[(blk * D + i) * D + j] = Jr[i][j];
      }
    }
  }
'''

# nvcc unrolls these as the kernel's own #pragma unroll loops
_COMBINE_DEFS, _COMBINE_STEP, _KEEP, _DIRECT = (
    x.replace("for (int ", '_Pragma("unroll") for (int ')
    for x in (_COMBINE_DEFS, _COMBINE_STEP, _KEEP, _DIRECT))

VARIANTS = {
    "full": [], "no steps": ["-DNO_STEPS=1"], "no stores": ["-DNO_STORES=1"],
    "loads only": ["-DNO_STEPS=1", "-DNO_STORES=1"], "combine": ["-DCOMBINE=1"],
    "direct stores": ["-DDIRECT_STORES=1"], "chunk 4": ["-DCHUNK=4"], "chunk 16": ["-DCHUNK=16"],
}
# the variants whose element is right
COMPUTING = ("full", "combine", "direct stores", "chunk 4", "chunk 16")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {"kalman_phase1": [_I] + [_P] * 4 + [_LL, _LL, _I] + [_P] * 6}


def variant_libs(root: Path) -> dict:
    """Every variant of csrc/kalman_scan.cu's K1 of ``root``, built."""
    src = (root / "gpar_at_scale_torch" / "csrc" / "kalman_scan.cu").read_text()
    if "// [K1 step]" not in src:
        raise SystemExit(f"k1_step_split: {root} has no staged K1 (no '// [K1 step]' marker)")
    step = src[src.index("      // [K1 step]\n"):src.index("      // [end K1 step]\n")]
    threads = int(re.search(r"constexpr int kK1Threads = (\d+);", src).group(1))
    warps = {f"{w - 1} copy warp{'s' if w > 2 else ''}": [f"-DTHREADS={32 * w}"]
             for w in (2, 4, 8) if 32 * w != threads}
    stores = src[src.index("  // [K1 stores]"):src.index("  // [end K1 stores]\n")]
    edits = (
        ("    for (int t = 0; t < rows; ++t) {\n      // [K1 step]",
         "    for (int t = 0; t < (NO_STEPS ? 0 : rows); ++t) {\n      // [K1 step]"),
        (step, f"#if COMBINE\n{_COMBINE_STEP}#else\n{step}#endif\n"),
        (stores, f"#if NO_STORES\n{_KEEP}#elif DIRECT_STORES\n{_DIRECT}#else\n{stores}#endif\n"),
        (f"constexpr int kK1Threads = {threads};",
         f"#ifndef THREADS\n#define THREADS {threads}\n#endif\nconstexpr int kK1Threads = THREADS;"),
        ("constexpr int kK1Chunk = 8;",
         "#ifndef CHUNK\n#define CHUNK 8\n#endif\nconstexpr int kK1Chunk = CHUNK;"),
        ("template <int D>\nstruct K1Smem {", _COMBINE_DEFS + "template <int D>\nstruct K1Smem {"),
    )
    source = _PRELUDE + patch_source("k1_step_split", edits, "kalman_scan", root)
    return build_variants(f"k1_step_split/{root.name}", source, {**VARIANTS, **warps}, _ENTRIES,
                          "kalman_scan", root)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose kernel is split")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_step_split: no CUDA device is available", file=sys.stderr)
        return 2
    from gpar_at_scale_torch.data.chain import make_chain_data
    from gpar_at_scale_torch.ops import kalman as ok

    cs = this_chip_smoke()
    root = Path(args.root).resolve()
    print(f"k1_step_split: K1 of {root}", flush=True)
    libs = variant_libs(root)
    print_clocks(libs["full"])
    stream = torch.cuda.current_stream().cuda_stream

    t_np, Y_np, _, _, _ = make_chain_data(cs.N, cs.N_STAR, 2, np.random.default_rng(args.seed))
    t = torch.as_tensor(t_np).to("cuda", torch.float32)
    Y = torch.as_tensor(Y_np).to("cuda", torch.float32)
    params = [torch.as_tensor(p).to("cuda", torch.float32) for p in cs.seeded_params(2, args.seed)]
    inp = cs.scan_inputs(t, Y, params, cs.M)
    A, Q, R, y, n, d, nb, T = (inp[k] for k in "A Q R y n d nb T".split())
    want = ok.phase1_plain(A, Q, R, y, nb, T)
    outs = tuple(torch.empty_like(w) for w in want)

    def call(lib):
        args_ = (d, *(x.data_ptr() for x in (A, Q, R, y)), n, T, nb,
                 *(x.data_ptr() for x in outs), stream)
        return lambda: lib.kalman_phase1(*args_) and sys.exit("kalman_phase1 failed")

    times = []
    for name, lib in libs.items():
        ms = event_ms(call(lib), args.reps)
        if name in COMPUTING or "copy warp" in name:
            call(lib)()
            torch.cuda.synchronize()
            rel = cs._rel_err(outs, want, "A b C eta J".split())[1]
            times.append(f"{name} {ms:.4f} (rel {rel:.1e})")
        else:
            times.append(f"{name} {ms:.4f}")
    print(f"K1 N={n} d={d} {nb}x{T}, ms: " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
