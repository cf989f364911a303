#!/usr/bin/env python3
"""Time K3 and K6a on the card, K6a split into its factorization and solve.

    python3 tools/time_k3_k6a.py [--root DIR ...] [--reps 20] [--seed 0]

Each ``--root`` is a checkout of this repository (default: the one holding
this script).  Each is timed in its own process, which imports that tree's
``gpar_at_scale_torch`` and ``chip_smoke.py`` and builds that tree's
kernels, so two trees can be compared on one card in one run (give them in
turns: parent, change, change, parent).  For each tree it prints, with CUDA
events over ``--reps`` launches after a warm-up:

* K3 (``whiten_sweep``) at the chain's main-path shapes -- N = 1e6 steps,
  d = 3 (Matern-5/2), B = M + 1 = 33 columns [y | K_fu] of the first
  conditional, the gains of the y = 0 filter pass -- without and with the
  filtered means, beside its plain version;
* at the EEG shapes (156, 157) and (256, 413) of ``chip_smoke.py``: K6a
  (``chol_solve``), K6a with k = 0 (the factorization alone), K6b
  (``tri_ut``) on K6a's factor with the same right-hand side (the solve
  alone), and the library calls ``cholesky_ex`` alone and ``cholesky_ex``
  + ``solve_triangular``.

The card's name and power limit are printed first.  Needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from tools.chip_timing import run_trees  # noqa: E402


def time_tree(root: Path, reps: int, seed: int) -> dict:
    """Every time of one tree, in ms, as a dict (run inside that tree's
    process: ``root`` is first on sys.path)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpar_at_scale_torch.data.chain import make_chain_data
    from gpar_at_scale_torch.data.eeg import generate_synthetic_eeg
    from gpar_at_scale_torch.kernels import time_kernel_only
    from gpar_at_scale_torch.models.gpar import GPARConfig, _select_pseudo_points, _unpack_cond
    from gpar_at_scale_torch.ops import dense
    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops import whiten as ow
    from gpar_at_scale_torch.ops.build import build_all
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    build_all()
    out = {}
    f32 = torch.float32

    # K3 on the first conditional's columns, as chip_smoke.check_kernels
    t_np, Y_np, _, _, _ = make_chain_data(cs.N, 10, 2, np.random.default_rng(seed))
    t = torch.as_tensor(t_np).to("cuda", f32)
    Y = torch.as_tensor(Y_np).to("cuda", f32)
    params = torch.as_tensor(cs.seeded_params(2, seed)[1]).to("cuda", f32)
    cfg = GPARConfig(backend="scaled", dtype=f32)
    tl, ts, ol, osig, ns, tns = _unpack_cond(cfg, params)
    lgssm = lgssm_of(time_kernel_only(cfg.time_family, tl, ts), t, tns**2, f32)
    X = Y[:, :1]
    out_k = cfg.out_family(lengthscale=ol, variance=osig**2)
    batch = torch.cat([Y[:, 1:2], out_k(X, _select_pseudo_points(X, cs.M))], dim=1).contiguous()
    A, _, _, y = ok._f32_inputs(lgssm, Y[:, 1])
    d = A.shape[-1]
    _, _, _, S, K, _, _ = ok.decorrelate_blocked(lgssm, torch.zeros_like(y), return_full=True)
    gains = ow.gain_rows(A, S, K)
    for want_means in (False, True):
        key = "K3 with means" if want_means else "K3"
        out[key] = cs._time_ms(lambda: ow.whiten_sweep(gains, batch, d, want_means=want_means),
                               reps=reps)
        out[key + " plain"] = cs._time_ms(
            lambda: ow.whiten_sweep_plain(gains, batch, d, want_means=want_means), reps=3)
    del gains, batch, Y, t

    # K6a split into factorization and solve, beside the library
    m = cs.dense_inputs(generate_synthetic_eeg(seed=0), "cuda")
    for S, B in ((m["Sigma_y"], m["batch"]), (m["Sigma_s"], m["both"])):
        n, k = B.shape
        empty = B[:, :0].contiguous()
        U = dense.chol_solve(S, B)[0]
        at = f"({n}, {k})"
        rows = {
            "K6a": lambda: dense.chol_solve(S, B),
            "K6a k=0": lambda: dense.chol_solve(S, empty),
            "K6b same (n, k)": lambda: dense.tri_ut(U, B),
            "library cholesky_ex": lambda: torch.linalg.cholesky_ex(S),
            "library cholesky_ex + solve_triangular": lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(S).L, B, upper=False),
        }
        for name, fn in rows.items():  # two rounds, in turns
            out[f"{name} {at}"] = [cs._time_ms(fn, reps=reps)]
        for name, fn in reversed(rows.items()):
            out[f"{name} {at}"].append(cs._time_ms(fn, reps=reps))
    return out


def main(argv=None):
    return run_trees(__file__, time_tree, 20, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    sys.exit(main())
