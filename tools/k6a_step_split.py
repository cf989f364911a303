#!/usr/bin/env python3
"""Split K6a's time on the card into its per-panel steps by leaving steps out.

    python3 tools/k6a_step_split.py [--reps 50]

Builds variants of the shared-memory K6a (``chol_solve_kernel`` in
``gpar_at_scale_torch/csrc/dense.cu``) with nvcc, each with some of its three
per-panel steps compiled out -- (1) the diagonal block's factorization on one
warp, (2) the panel's forward substitution per column, (3) the rank-16
update -- and times each with CUDA events, calling the C entry directly, at
the EEG shapes with and without the right-hand side.  A variant's results
are wrong; only its time is read.  "none" leaves out all three steps (what
is left: the loads, the stores, the barriers and the logdet).  It also
prints the SM clock measured by a kernel spinning on clock64(), beside
nvidia-smi's, so a slow step is not mistaken for a slow clock.  Needs a
CUDA device and nvcc; writes its builds under build/k6a_step_split/.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.chip_timing import build_variants, event_ms, patch_source, print_clocks  # noqa: E402

# Text of csrc/dense.cu around each step of chol_solve_kernel, and the guards
# put around it.
_STEP1_BEGIN = "    if (warp == 0) {\n      float col[kNB];"
_STEP1_END = ("        ldv[r0 + lane] = static_cast<double>(fmaxf(my_pivot * my_inv, kTiny));\n"
              "      }\n    }\n    __syncthreads();\n")
_STEP2_END = "    __syncthreads();\n\n    // 3. rank-nbp update"
_STEP3_END = ("              if (l + c < lim && (rhs || l + c >= i)) row[l + c] -= acc[r][4 * h + c];\n"
              "          }\n        }\n      }\n    }\n    __syncthreads();\n  }\n")
VARIANTS = {
    "full": [], "no step 1": ["-DSKIP1"], "no step 2": ["-DSKIP2"], "no step 3": ["-DSKIP3"],
    "step 3 alone": ["-DSKIP1", "-DSKIP2"], "none": ["-DSKIP1", "-DSKIP2", "-DSKIP3"],
}


def guarded_source() -> str:
    """csrc/dense.cu with #ifndef SKIPn around step n of chol_solve_kernel."""
    return patch_source("k6a_step_split", (
        (_STEP1_BEGIN, "#ifndef SKIP1\n" + _STEP1_BEGIN),
        (_STEP1_END, _STEP1_END.replace("    __syncthreads();\n",
                                        "#endif\n    __syncthreads();\n#ifndef SKIP2\n")),
        (_STEP2_END, "#endif\n" + _STEP2_END.replace("\n\n", "\n#ifndef SKIP3\n")),
        (_STEP3_END, _STEP3_END.replace("    __syncthreads();\n  }\n",
                                        "#endif\n    __syncthreads();\n  }\n")),
    ))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k6a_step_split: no CUDA device is available", file=sys.stderr)
        return 2
    argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    libs = build_variants("k6a_step_split", guarded_source(), VARIANTS,
                          {"dense_chol_solve": argtypes})
    print_clocks(libs["full"])
    stream = torch.cuda.current_stream().cuda_stream

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, k in ((156, 0), (156, 157), (256, 0), (256, 413)):
        A = torch.randn(n, n, device="cuda", generator=gen)
        S = (A @ A.T + n * torch.eye(n, device="cuda")).contiguous()
        B = torch.randn(n, k, device="cuda", generator=gen)
        U, W = torch.empty_like(S), torch.empty_like(B)
        ld = torch.empty(1, device="cuda")
        info = torch.empty(1, dtype=torch.int32, device="cuda")
        times = []
        for name, lib in libs.items():
            def call(fn=lib.dense_chol_solve):
                rc = fn(S.data_ptr(), B.data_ptr() if k else None, n, k, 1, U.data_ptr(),
                        W.data_ptr() if k else None, ld.data_ptr(), info.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"dense_chol_solve failed with cudaError {rc}")
            times.append(f"{name} {event_ms(call, args.reps):.4f}")
        print(f"K6a (n, k) = ({n}, {k}), ms: " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
