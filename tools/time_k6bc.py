#!/usr/bin/env python3
"""Time K6b and K6c on the card, beside ``torch.linalg.solve_triangular``.

    python3 tools/time_k6bc.py [--root DIR ...] [--reps 50] [--seed 0]

Each ``--root`` is a checkout of this repository (default: the one holding
this script).  Each is timed in its own process, which imports that tree's
``gpar_at_scale_torch`` and builds that tree's kernels, so two trees can be
compared on one card in one run (give them in turns: parent, change,
change, parent).  The measuring code is this tree's ``chip_smoke.py``, loaded
by path, so every tree is measured the same way.  For each tree it prints:

* at (n, k) = (156, 157) and (156, 256), the EEG shapes of ``chip_smoke.py``
  (U = chol(K_uu)^T of FZ's scaled conditional with [y | K_fu] and with
  K_*u^T), and at (512, 600): K6b (``tri_ut``) and K6c (``tri_u``), each
  with its CUDA-event time over ``--reps`` back-to-back calls and its
  device time per call from ``torch.profiler``, beside
  ``solve_triangular`` on the same operands, and its largest relative
  difference from its plain version;
* an empty launch (``torch.cuda._sleep(0)``) timed the same way: the
  practical floor under a kernel's time;
* one traced ``bench.py`` pipeline (``chip_smoke.bench_pipeline``) under
  ``engine.pallas_dense = "on"``: its K6b and K6c launches, their device
  time, and the device copies it ran.

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

    from gpar_at_scale_torch.data.eeg import generate_synthetic_eeg
    from gpar_at_scale_torch.ops import dense
    from gpar_at_scale_torch.ops.build import build_all

    cs = this_chip_smoke()
    build_all()
    f32 = torch.float32
    m = cs.dense_inputs(generate_synthetic_eeg(seed=0), "cuda")
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.normal(size=(512, 512)), device="cuda")
    L512 = torch.linalg.cholesky(A @ A.T + 512 * torch.eye(512, device="cuda", dtype=A.dtype))
    L512 = L512.to(f32).contiguous()
    B512 = torch.as_tensor(rng.normal(size=(512, 600))).to("cuda", f32)
    shapes = ((m["L"], m["batch"]), (m["L"], m["Kus"]), (L512, B512))

    def both(fn):
        return {"event_ms": cs._time_ms(fn, reps=reps), "device_ms": cs._device_ms(fn, reps=reps)}

    out = {"empty launch": both(lambda: torch.cuda._sleep(0))}
    for L, B in shapes:
        U = L.T.contiguous()
        at = f"({L.shape[0]}, {B.shape[1]})"
        for name, fn, lib in (
            ("K6b", dense.tri_ut, lambda: torch.linalg.solve_triangular(L, B, upper=False)),
            ("K6c", dense.tri_u, lambda: torch.linalg.solve_triangular(U, B, upper=True)),
        ):
            got, want = fn(U, B), fn(U, B, plain=True)
            rel = float((got - want).abs().max() / want.abs().max())
            out[f"{name} {at}"] = dict(both(lambda: fn(U, B)), rel=rel)
            out[f"{name} library {at}"] = both(lib)

    # one bench.py pipeline under "on", traced
    pipeline, _ = cs.bench_pipeline()
    cs._set_dense_mode("on")
    try:
        pipeline()
        before = (dense.K6B.launches, dense.K6C.launches)
        parts = cs._device_kernels(pipeline)
        after = (dense.K6B.launches, dense.K6C.launches)
    finally:
        cs._set_dense_mode("off")
    out["pipeline"] = {
        "K6b launches": after[0] - before[0], "K6c launches": after[1] - before[1],
        "tri_kernel device ms": sum(ms for k, _, ms in parts if "tri_kernel" in k),
        "device copies": sum(c for k, c, _ in parts if "copy" in k.lower()),
        "device launches": sum(c for _, c, _ in parts),
    }
    return out


def main(argv=None):
    return run_trees(__file__, time_tree, 50, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    sys.exit(main())
