#!/usr/bin/env python3
"""Split K6b's and K6c's time on the card into their per-panel steps by
leaving steps out.

    python3 tools/k6bc_step_split.py [--reps 200]

Builds variants of ``tri_kernel`` (``gpar_at_scale_torch/csrc/dense.cu``)
with nvcc, each with some of its per-panel steps compiled out -- (1) the
substitution of the panel's pivots, (2) the rank-16 update of the tile's
later rows, (3) the copy of the next panel's coefficients (a variant
without it solves every panel with stale ones) -- or with another tile
width (kTriKT = 32, 64 columns per block), and times each with CUDA
events, calling the C entry directly, for K6b and K6c at (n, k) =
(156, 157), (156, 256) and (512, 600).  A variant that leaves a step out
gives wrong results; only its time is read.  "none" leaves out all three
steps (what is left: the tile's load and store, the reciprocals, the
barriers).  It also prints the SM clock measured by a
kernel spinning on clock64(), beside nvidia-smi's.  Needs a CUDA device and
nvcc; writes its builds under build/k6bc_step_split/.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.chip_timing import build_variants, event_ms, patch_source, print_clocks  # noqa: E402

# Text of csrc/dense.cu around each step of tri_kernel, and the guards put
# around it.
_STEP1 = ("    // 1. the panel's pivots, one column of the tile per thread\n",
          "    __syncthreads();\n\n    // 2. rank-16 update")
_STEP2 = ("    const int lo = kForward ? r0 + nbp : 0, hi = kForward ? n : r0;\n",
          "  }\n  __syncthreads();\n  for (int idx = tid; idx < n * KT; idx += kTriThreads) {")
_STEP3 = "    if (p + 1 < npanels) load_panel(p + 1, (p + 1) & 1);\n"
_KT = "constexpr int kTriKT = 16;"
VARIANTS = {
    "full": [], "no step 1": ["-DSKIP1"], "no step 2": ["-DSKIP2"], "no step 3": ["-DSKIP3"],
    "step 3 alone": ["-DSKIP1", "-DSKIP2"], "none": ["-DSKIP1", "-DSKIP2", "-DSKIP3"],
    "kt=32": ["-DTRI_KT=32"], "kt=64": ["-DTRI_KT=64"],
}


def guarded_source() -> str:
    """csrc/dense.cu with #ifndef SKIPn around step n of tri_kernel, and
    its tile width taken from TRI_KT where that is defined."""
    return patch_source("k6bc_step_split", (
        (_STEP1[0], "#ifndef SKIP1\n" + _STEP1[0]),
        (_STEP1[1], "#endif\n" + _STEP1[1]),
        (_STEP2[0], "#ifndef SKIP2\n" + _STEP2[0]),
        (_STEP2[1], "#endif\n" + _STEP2[1]),
        (_STEP3, "#ifndef SKIP3\n" + _STEP3 + "#endif\n"),
        (_KT, "#ifndef TRI_KT\n#define TRI_KT 16\n#endif\nconstexpr int kTriKT = TRI_KT;"),
    ))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k6bc_step_split: no CUDA device is available", file=sys.stderr)
        return 2
    argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    libs = build_variants("k6bc_step_split", guarded_source(), VARIANTS,
                          {"dense_tri_ut": argtypes, "dense_tri_u": argtypes})
    print_clocks(libs["full"])
    stream = torch.cuda.current_stream().cuda_stream

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, k in ((156, 157), (156, 256), (512, 600)):
        A = torch.randn(n, n, device="cuda", generator=gen, dtype=torch.float64)
        L = torch.linalg.cholesky(A @ A.T + n * torch.eye(n, device="cuda", dtype=A.dtype))
        U = L.T.float().contiguous()
        B = torch.randn(n, k, device="cuda", generator=gen)
        X = torch.empty_like(B)
        for kernel, sym in (("K6b", "dense_tri_ut"), ("K6c", "dense_tri_u")):
            times = []
            for name, lib in libs.items():
                def call(fn=getattr(lib, sym)):
                    rc = fn(U.data_ptr(), B.data_ptr(), n, k, 1, X.data_ptr(), stream)
                    if rc != 0:
                        raise RuntimeError(f"{sym} failed with cudaError {rc}")
                times.append(f"{name} {event_ms(call, args.reps):.4f}")
            print(f"{kernel} (n, k) = ({n}, {k}), ms: " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
