"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, many seeds in one process:

    python -m portbench.calibrate --workload <cell> --mode program --seeds 1,2,...
    python -m portbench.calibrate --workload <cell> --mode control --seeds 1,2,3
    python -m portbench.calibrate --workload <cell> --mode fault:half_batch --seeds 1,2,3

``program``: sound runs of the program (a short window, the run's own
check); the lower reading of each number is their largest.  ``control``:
the plain reference at the precision below the configuration's, put in the
program's place.  ``fault:<name>``: a fault of ``faults.py`` planted in the
program.  The upper reading of a number is the smallest that the control
or a fault gives.  One JSON line per seed, then one with the summary.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload, mode, seeds, seconds):
    from portbench import cells, faults
    from portbench.run import log, run_cell

    cell = cells.resolve(workload)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        try:
            if mode == "program":
                numbers = {k: v["value"] for k, v in
                           run_cell(workload, seed, seconds, False, "cuda", t0=t0)["checks"].items()}
            elif mode == "control":
                numbers = control(cell, seed, seconds)
            else:
                fault = faults.BY_LOOP[cell.traffic["loop"]][mode.split(":", 1)[1]]
                with fault():
                    numbers = {k: v["value"] for k, v in
                               run_cell(workload, seed, seconds, False, "cuda", t0=t0)["checks"].items()}
        except Exception as e:  # a control or fault that crashes has failed
            numbers = {"crash": f"{type(e).__name__}: {e}"[:300]}
        rec = {"seed": seed, "mode": mode, "numbers": numbers, "s": time.perf_counter() - t0}
        log(json.dumps(rec))
        print(json.dumps(rec), flush=True)
        out.append(numbers)
    return out


def control(cell, seed, seconds):
    """The cell's numbers with the reference's control in the program's
    place: the loop's set-up makes the data (and, serving, the fit the
    control answers from), then ``control_numbers`` of the loop."""
    from types import SimpleNamespace

    from portbench import cells

    loop = cells.load_module(cell.paths["loop"])
    ref = cells.load_module(cell.paths["reference"])
    run = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, device="cuda")
    st = loop.setup(run)
    loop.release(st)
    return loop.control_numbers(run, st, ref)


def summary(mode, recs):
    keys = sorted({k for r in recs for k in r if k != "crash"})
    crashes = sum(1 for r in recs if "crash" in r)
    pick = max if mode == "program" else min
    return {"mode": mode, "seeds": len(recs), "crashes": crashes,
            "reading": {k: pick(r[k] for r in recs if k in r) for k in keys}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    from portbench.run import environment

    environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate reads the card: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    recs = readings(args.workload, args.mode, seeds, args.seconds)
    print(json.dumps({"summary": summary(args.mode, recs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
