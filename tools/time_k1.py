#!/usr/bin/env python3
"""Time K1 on the card, on the main path's inputs.

    python3 tools/time_k1.py [--root DIR ...] [--reps 50] [--seed 0]

Each ``--root`` is a checkout of this repository (default: the one holding
this script).  Each is timed in its own process, which imports that tree's
``gpar_at_scale_torch`` and builds that tree's kernels, so two trees can be
compared on one card in one run (give them in turns: parent, change,
change, parent).  The measuring code is this tree's ``chip_smoke.py``, loaded
by path, so every tree is measured the same way.  On the chain's first
conditional (``chip_smoke.scan_inputs``: N = 1e6, d = 3, 16384 blocks of 62
steps, made from ``--seed``) it prints for each tree:

* K1 on the conditional's observations (as ``chip_smoke.py``'s
  ``[kernels]`` records it) and on y = 0 (the gain pass of conditioning,
  serving and training): each with its CUDA-event time over ``--reps``
  back-to-back calls, its device time per call from ``torch.profiler``,
  and its largest relative difference from its plain version;
* an empty launch (``torch.cuda._sleep(0)``) timed the same way: the
  practical floor under a kernel's time;
* one traced Adam step of that conditional's DTC bound from its seeded
  log-parameters: the launches and device time of K1 in it, and of all
  its device kernels and copies.

The card's name and power limit are printed first.  Needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from tools.chip_timing import run_trees, this_chip_smoke  # noqa: E402


def time_tree(root: Path, reps: int, seed: int) -> dict:
    """Every number of one tree (run inside that tree's process: ``root``
    is first on sys.path)."""
    import numpy as np
    import torch

    from gpar_at_scale_torch.data.chain import make_chain_data
    from gpar_at_scale_torch.gp.dtc import dtc_objective
    from gpar_at_scale_torch.inference.optimize import minimize_adam
    from gpar_at_scale_torch.models.gpar import (
        GPARConfig,
        _conditional_bound,
        _select_pseudo_points,
    )
    from gpar_at_scale_torch.ops import kalman as ok
    from gpar_at_scale_torch.ops.build import build_all

    cs = this_chip_smoke()
    build_all()
    f32 = torch.float32
    t_np, Y_np, _, _, _ = make_chain_data(cs.N, cs.N_STAR, 2, np.random.default_rng(seed))
    t, Y = (torch.as_tensor(x).to("cuda", f32) for x in (t_np, Y_np))
    params = [torch.as_tensor(p).to("cuda", f32) for p in cs.seeded_params(2, seed)]
    inp = cs.scan_inputs(t, Y, params, cs.M)
    A, Q, R, y, nb, T = (inp[k] for k in "A Q R y nb T".split())

    def both(fn):
        return {"event_ms": cs._time_ms(fn, reps=reps), "device_ms": cs._device_ms(fn, reps=reps)}

    def rel(got, want):
        return cs._rel_err(got, want, "A b C eta J".split())[1]

    out = {"empty launch": both(lambda: torch.cuda._sleep(0))}
    for label, y1 in (("K1", y), ("K1 y=0", torch.zeros_like(y))):
        fn = lambda y1=y1: ok.phase1(A, Q, R, y1, nb, T)  # noqa: E731
        out[label] = dict(both(fn), rel=rel(fn(), ok.phase1_plain(A, Q, R, y1, nb, T)))

    # one Adam step of the conditional's bound, traced
    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=cs.M, dtype=f32,
                     optimizer="adam")
    X = Y[:, :1]
    at = _conditional_bound(cfg, t, X, Y[:, 1], _select_pseudo_points(X, cs.M))
    step = lambda: minimize_adam(lambda p: -at(dtc_objective, p), params[1], max_steps=1)  # noqa: E731
    step()
    parts = cs._device_kernels(step)
    k1 = [(c, ms) for k, c, ms in parts if "phase1_kernel" in k]
    out["train step"] = {
        "phase1_kernel launches": sum(c for c, _ in k1),
        "phase1_kernel device ms": sum(ms for _, ms in k1),
        "all device ms": sum(ms for _, _, ms in parts),
        "all launches": sum(c for _, c, _ in parts),
    }
    return out


def main(argv=None):
    return run_trees(__file__, time_tree, 50, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    sys.exit(main())
