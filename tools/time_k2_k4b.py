#!/usr/bin/env python3
"""Time K2 and K4b on the card, on the main path's inputs.

    python3 tools/time_k2_k4b.py [--root DIR ...] [--reps 50] [--seed 0]

Each ``--root`` is a checkout of this repository (default: the one holding
this script).  Each is timed in its own process, which imports that tree's
``gpar_at_scale_torch`` and builds that tree's kernels, so two trees can be
compared on one card in one run (give them in turns: parent, change,
change, parent).  The measuring code is this tree's ``chip_smoke.py``, loaded
by path, so every tree is measured the same way.  On the chain's first
conditional (``chip_smoke.scan_inputs``: N = 1e6, d = 3, 16384 blocks of 62
steps, made from ``--seed``) it prints for each tree:

* K2 asked for every output (as ``chip_smoke.py``'s ``[kernels]`` records
  it) and for alpha, log S and K alone (the gain pass of conditioning and
  serving), and K4b on the whitened-Gram adjoint's elements at C = 1 and
  C = M + 1 = 33: each with its CUDA-event time over ``--reps`` back-to-back
  calls and its device time per call from ``torch.profiler``, and its
  largest relative difference from its plain version;
* an empty launch (``torch.cuda._sleep(0)``) timed the same way: the
  practical floor under a kernel's time;
* one traced Adam step of that conditional's DTC bound from its seeded
  log-parameters: the launches and device time of K2 and K4b in it, and of
  all its device kernels and copies.

The card's name and power limit are printed first.  Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from tools.chip_timing import run_trees  # noqa: E402


def _this_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    from gpar_at_scale_torch.ops import smoother as osm
    from gpar_at_scale_torch.ops.build import build_all

    cs = _this_chip_smoke()
    build_all()
    f32 = torch.float32
    t_np, Y_np, _, _, _ = make_chain_data(cs.N, cs.N_STAR, 2, np.random.default_rng(seed))
    t, Y = (torch.as_tensor(x).to("cuda", f32) for x in (t_np, Y_np))
    params = [torch.as_tensor(p).to("cuda", f32) for p in cs.seeded_params(2, seed)]
    inp = cs.scan_inputs(t, Y, params, cs.M)
    A, Q, R, y, nb, T = (inp[k] for k in "A Q R y nb T".split())
    m0, P0 = ok.block_inits(*ok.phase1(A, Q, R, y, nb, T))

    def both(fn):
        return {"event_ms": cs._time_ms(fn, reps=reps), "device_ms": cs._device_ms(fn, reps=reps)}

    def rel(got, want):
        return max(float((g.double() - w.double()).abs().max() / w.abs().max())
                   for g, w in zip(got, want) if g is not None)

    out = {"empty launch": both(lambda: torch.cuda._sleep(0))}
    k2 = lambda moments: ok.phase3(A, Q, R, y, m0, P0, nb, T, True, moments)  # noqa: E731
    out["K2"] = dict(both(lambda: k2(True)),
                     rel=rel(k2(True), ok.phase3_plain(A, Q, R, y, m0, P0, nb, T)))
    out["K2 gains only"] = both(lambda: k2(False))
    E, b, W = cs.adjoint_elements(A, Q, R, inp["batch"])
    for C in (1, b.shape[2]):
        g = b[:, :, :C].contiguous()
        g0, L0 = osm.block_suffix_inits(*osm.suffix_reduce(E, g, W, nb, T))
        fn = lambda: osm.suffix_replay(E, g, W, g0, L0, nb, T)  # noqa: E731
        out[f"K4b C={C}"] = dict(both(fn), rel=rel(fn(), osm.r3_plain(E, g, W, g0, L0, nb, T)))
    del E, b, W

    # one Adam step of the conditional's bound, traced
    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=cs.M, dtype=f32,
                     optimizer="adam")
    X = Y[:, :1]
    at = _conditional_bound(cfg, t, X, Y[:, 1], _select_pseudo_points(X, cs.M))
    step = lambda: minimize_adam(lambda p: -at(dtc_objective, p), params[1], max_steps=1)  # noqa: E731
    step()
    parts = cs._device_kernels(step)
    out["train step"] = {
        f"{name} {what}": sum((c if what == "launches" else ms) for k, c, ms in parts if name in k)
        for name in ("phase3_kernel", "suffix_replay_kernel") for what in ("launches", "device ms")
    }
    out["train step"]["all device ms"] = sum(ms for _, _, ms in parts)
    out["train step"]["all launches"] = sum(c for _, c, _ in parts)
    return out


def main(argv=None):
    return run_trees(__file__, time_tree, 50, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    sys.exit(main())
