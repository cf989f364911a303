#!/usr/bin/env python3
"""Split K2's and K4b's time on the card by leaving parts of them out.

    python3 tools/k2_k4b_step_split.py [--root DIR] [--reps 50] [--seed 0]

Builds variants of ``phase3_kernel`` (``csrc/kalman_scan.cu``) and of
``suffix_replay_kernel`` (``csrc/suffix_scan.cu``) of the checkout DIR
(default: the one holding this script) with nvcc, and times each with CUDA
events, calling the C entry directly, at the main path's shapes: K2 on
the chain's first conditional (``chip_smoke.scan_inputs``: N = 1e6, d = 3,
16384 blocks of 62 steps) from the inits of K1's plain version; K4b on
seeded contracting E, symmetric L and normal g of the same n, d and
blocking, at C = 1 and C = M + 1 = 33.  The inputs are made without this
checkout's kernels, so a tree whose kernels do not build can still be
split beside it.  Variants:

* K4b: "no matrix" leaves out the M recursion, "no columns" the column
  threads' v recursion, "no stores" the stores of v and M (the values are
  still computed), "loads only" all three;
* K2: "no steps" leaves out the filter's steps, "no stores" the stores of
  the outputs, "loads only" both; "no K, m, P" is the full kernel asked
  for alpha and log S alone (a run-time option);
* for this design (staged through shared memory), "chunk 4" and
  "chunk 16" stage 4 or 16 steps at a time instead of 8, and "other
  threads" gives each CUDA block at least 8 warps instead of 4 (K2) or 4
  instead of 8 (K4b; the warps beyond those that compute only stage and
  store); "series-aligned" and
  "block-anchored" force the chunks onto windows aligned to the series or
  counted back from each block's end (the kernels choose: K2 always the
  first, K4b the first where a chunk's g rows are at most 64 floats).

It knows two designs -- the staged kernels and the one-thread-per-block
kernels before them (give that checkout as ``--root``) -- and picks the
markers of the one it finds.  A variant that leaves a part out gives wrong
results; only its time is read.  It also prints the SM clock measured by a
kernel spinning on clock64(), beside nvidia-smi's.  Needs a CUDA device and
nvcc; writes its builds under build/k2_k4b_step_split/.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.chip_timing import build_variants, event_ms, patch_source, print_clocks  # noqa: E402

# Switches put in front of a source: each part is on unless its variant
# defines the switch as 1.
_PRELUDE = "".join(f"#ifndef {k}\n#define {k} {v}\n#endif\n" for k, v in (
    ("NO_MAT", 0), ("NO_COLS", 0), ("NO_STORES", 0), ("NO_STEPS", 0), ("ALIGN", -1)))
_SKIP = "1.2345e-30f"  # a value never computed: a store kept only to keep its value live

# The staged kernels: text of each part, and what a variant makes of it.
STAGED = {
    "suffix_scan": (
        ("const bool is_col = tid < tbc * bt", "const bool is_col = !NO_COLS && tid < tbc * bt"),
        ("const bool is_mat = mat && jm >= 0", "const bool is_mat = !NO_MAT && mat && jm >= 0"),
        ("    store(ch);  // [K4b stores]\n", "    if (!NO_STORES) store(ch);\n"),
        ("constexpr int kChunk = 8;",
         "#ifndef CHUNK\n#define CHUNK 8\n#endif\nconstexpr int kChunk = CHUNK;"),
        ("const int threads = max(256, ",
         "#ifndef THREADS\n#define THREADS 256\n#endif\n  const int threads = max(THREADS, "),
        ("const bool aligned = kChunk * d * C <= 64;",
         "const bool aligned = ALIGN < 0 ? kChunk * d * C <= 64 : ALIGN == 1;"),
    ),
    "kalman_scan": (
        ("    for (int t = 0; t < rows; ++t) {\n      float Ak[D][D], Pp[D][D], AP[D][D];",
         "    for (int t = 0; t < (NO_STEPS ? 0 : rows); ++t) {\n"
         "      float Ak[D][D], Pp[D][D], AP[D][D];"),
        ("    store(ch);\n    __syncthreads();\n  }\n  if (tid < NB && blk < nblocks) {",
         "    if (!NO_STORES) store(ch);\n    __syncthreads();\n  }\n  if (tid < NB && blk < nblocks) {"),
        ("constexpr int kK2Threads = 128;",
         "#ifndef THREADS\n#define THREADS 128\n#endif\nconstexpr int kK2Threads = THREADS;"),
        ("constexpr int kK2Chunk = 8;",
         "#ifndef CHUNK\n#define CHUNK 8\n#endif\nconstexpr int kK2Chunk = CHUNK;"),
        ("gpar::window_origin<CH>(blk * T, len, true)",
         "gpar::window_origin<CH>(blk * T, len, ALIGN != 0)"),
    ),
}
# The kernels before them: one thread per time block, reading and writing
# device memory at every step.
THREADED = {
    "suffix_scan": (
        ("    for (long long k = stop - 1; k >= start; --k) {\n      affine<D>(E, g, k, C, c, v);\n"
         "#pragma unroll\n      for (int i = 0; i < D; ++i) v_out[(k * D + i) * C + c] = v[i];",
         "    for (long long k = stop - 1; !NO_COLS && k >= start; --k) {\n"
         "      affine<D>(E, g, k, C, c, v);\n#pragma unroll\n      for (int i = 0; i < D; ++i)"
         f" if (!NO_STORES || v[i] == {_SKIP}) v_out[(k * D + i) * C + c] = v[i];"),
        ("    load_mat<D>(L0, blk, Ms);\n    for (long long k = stop - 1; k >= start; --k) {",
         "    load_mat<D>(L0, blk, Ms);\n    for (long long k = stop - 1; !NO_MAT && k >= start; --k) {"),
        ("        for (int j = 0; j < D; ++j) M_out[k * D * D + i * D + j] = Ms[i][j];",
         f"        for (int j = 0; j < D; ++j) if (!NO_STORES || Ms[i][j] == {_SKIP})"
         " M_out[k * D * D + i * D + j] = Ms[i][j];"),
    ),
    "kalman_scan": (
        ("  for (long long k = start; k < stop; ++k) {\n    float Ak[D][D], Pp[D][D], AP[D][D];",
         "  for (long long k = start; k < (NO_STEPS ? start : stop); ++k) {\n"
         "    float Ak[D][D], Pp[D][D], AP[D][D];"),
        ("    alpha[k] = a;\n    logs[k] = logS;\n",
         "    if (!NO_STORES) {\n      alpha[k] = a;\n      logs[k] = logS;\n    }\n"),
    ),
}
K4B_VARIANTS = {
    "full": [], "no matrix": ["-DNO_MAT=1"], "no columns": ["-DNO_COLS=1"],
    "no stores": ["-DNO_STORES=1"], "loads only": ["-DNO_MAT=1", "-DNO_COLS=1", "-DNO_STORES=1"],
}
K2_VARIANTS = {
    "full": [], "no steps": ["-DNO_STEPS=1"], "no stores": ["-DNO_STORES=1"],
    "loads only": ["-DNO_STEPS=1", "-DNO_STORES=1"],
}
SHAPES = {"chunk 4": ["-DCHUNK=4"], "chunk 16": ["-DCHUNK=16"],
          "series-aligned": ["-DALIGN=1"], "block-anchored": ["-DALIGN=0"]}
OTHER_THREADS = {"kalman_scan": 256, "suffix_scan": 128}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {
    "kalman_scan": {"kalman_phase3": [_I] + [_P] * 4 + [_LL, _LL, _I] + [_P] * 10},
    "suffix_scan": {"suffix_replay": [_I] + [_P] * 3 + [_LL, _LL, _I, _I] + [_P] * 5},
}


def variant_libs(root: Path, name: str, variants: dict) -> dict:
    """Every variant of csrc/<name>.cu of ``root``, built."""
    staged = "staging.cuh" in (root / "gpar_at_scale_torch" / "csrc" / f"{name}.cu").read_text()
    edits = (STAGED if staged else THREADED)[name]
    if staged:
        variants = {**variants, **SHAPES, "other threads": [f"-DTHREADS={OTHER_THREADS[name]}"]}
    source = _PRELUDE + patch_source("k2_k4b_step_split", edits, name, root)
    return build_variants(f"k2_k4b_step_split/{root.name}", source, variants, _ENTRIES[name],
                          name, root)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose kernels are split")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_k4b_step_split: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gpar_at_scale_torch.data.chain import make_chain_data
    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import smoother as osm

    root = Path(args.root).resolve()
    print(f"k2_k4b_step_split: kernels of {root}", flush=True)
    k2 = variant_libs(root, "kalman_scan", K2_VARIANTS)
    k4b = variant_libs(root, "suffix_scan", K4B_VARIANTS)
    print_clocks(k2["full"])
    stream = torch.cuda.current_stream().cuda_stream

    t_np, Y_np, _, _, _ = make_chain_data(cs.N, cs.N_STAR, 2, np.random.default_rng(args.seed))
    t = torch.as_tensor(t_np).to("cuda", torch.float32)
    Y = torch.as_tensor(Y_np).to("cuda", torch.float32)
    params = [torch.as_tensor(p).to("cuda", torch.float32) for p in cs.seeded_params(2, args.seed)]
    inp = cs.scan_inputs(t, Y, params, cs.M)
    A, Q, R, y, n, d, nb, T = (inp[k] for k in "A Q R y n d nb T".split())
    m0, P0 = ok.block_inits(*ok.phase1_plain(A, Q, R, y, nb, T))
    new = lambda *s: torch.empty(s, dtype=torch.float32, device="cuda")  # noqa: E731
    outs = (new(n), new(n), new(n, d), new(n, d), new(n, d, d), new(nb), new(nb))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731

    def k2_call(lib, full=True):
        alpha, logs, K, m, P, ll, ls = outs if full else outs[:2] + (None,) * 3 + outs[5:]
        args_ = (d, *map(ptr, (A, Q, R, y)), n, T, nb, ptr(m0), ptr(P0),
                 *map(ptr, (alpha, logs, K, m, P, ll, ls)), stream)
        return lambda: lib.kalman_phase3(*args_) and sys.exit("kalman_phase3 failed")

    times = [f"{v} {event_ms(k2_call(lib), args.reps):.4f}" for v, lib in k2.items()]
    times.append(f"no K, m, P {event_ms(k2_call(k2['full'], full=False), args.reps):.4f}")
    print(f"K2 N={n} {nb}x{T}, ms: " + ", ".join(times), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rand = lambda *s: torch.rand(s, device="cuda", generator=gen) * 2 - 1  # noqa: E731
    E = (0.6 / d) * rand(n, d, d)
    X = rand(n, d, d)
    W = (0.5 * (X + X.transpose(1, 2))).contiguous()
    for C in (1, cs.M + 1):
        g = torch.randn(n, d, C, device="cuda", generator=gen)
        g0, L0 = osm.block_suffix_inits(*osm.r1_plain(E, g, W, nb, T))
        v, M = new(n, d, C), new(n, d, d)

        def call(lib):
            args_ = (d, *map(ptr, (E, g, W)), n, T, nb, C, *map(ptr, (g0, L0, v, M)), stream)
            return lambda: lib.suffix_replay(*args_) and sys.exit("suffix_replay failed")

        print(f"K4b C={C}, ms: " + ", ".join(
            f"{name} {event_ms(call(lib), args.reps):.4f}" for name, lib in k4b.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
