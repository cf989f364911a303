#!/usr/bin/env python3
"""How many device kernel records torch.profiler keeps late in a process.

    python3 tools/profiler_drop.py [--sessions 30] [--launches 20000]

Builds the kernels, then alternates profiler sessions over ``--launches``
small elementwise launches each (``chip_smoke.profile_phase`` every third
session, ``chip_smoke._device_kernels`` otherwise, as ``chip_smoke.py``'s
phases use them) with, every fifth session, a ``utils.profiler_trace``
around one K3 sweep (N = 10^6, 33 columns; its four device kernels). After
each trace it prints the launches traced so far, the trace's events, the
device kernel records in it (of 4) and the file's bytes. The card's name
and power limit are printed first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=30)
    ap.add_argument("--launches", type=int, default=20000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profiler_drop: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gpar_at_scale_torch.ops.build import build_all
    from gpar_at_scale_torch.ops.grad import gain_pass
    from gpar_at_scale_torch.ops.whiten import whiten_sweep
    from gpar_at_scale_torch.utils import profiler_trace

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip(), flush=True)
    build_all()
    n = 1_000_000
    t = torch.linspace(0.0, n / 1000.0, n, dtype=torch.float64, device="cuda")
    lg = cs._pod_lgssm(t, torch.tensor([math.log(0.5), 0.0, math.log(0.1)], dtype=torch.float64,
                                       device="cuda"))
    rows = gain_pass(lg.A, lg.Q, lg.R.expand(n).contiguous())[0]
    U = torch.randn(n, 33, device="cuda")
    x = torch.ones(64, device="cuda")

    def many():
        for _ in range(args.launches):
            x.add_(1e-9)

    traced = 0
    out_dir = ROOT / "build" / "profiler_drop"
    for i in range(args.sessions):
        if i % 3 == 0:
            cs.profile_phase(f"session {i}", many)
        else:
            cs._device_kernels(many)
        traced += args.launches
        if i % 5 == 4:
            d = out_dir / f"trace{i}"
            with profiler_trace(str(d)):
                whiten_sweep(rows, U, 3)
                torch.cuda.synchronize()
            path = d / "trace.json"
            events = json.load(open(path))["traceEvents"]
            kernels = sum(1 for e in events if e.get("cat") == "kernel")
            print(f"after {traced:,} traced launches: {len(events)} events, {kernels} of the "
                  f"sweep's 4 device kernels, {os.path.getsize(path):,} bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
