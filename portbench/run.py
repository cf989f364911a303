"""Run one cell of the port's benchmark on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (data and weights from the seed on the device, the kernels' build
or load from ``build/kernels/``, one warm-up of the cell's shapes) is
``setup_s``; then the window runs for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics) or a short piece of work runs under the
profiler (``--trace 1``: its per-layer metrics).  Afterwards the plain
reference checks a sample of what the window produced.  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Exits non-zero with no result without a CUDA card (or with fewer than the
cell asks for), and when JAX or the JAX package is loaded by the end.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpar_at_scale_tpu")


def environment():
    """Caches inside the checkout at fixed paths; the configuration file,
    not the environment, decides the program's switches."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    for var in ("GPAR_PALLAS_DENSE", "GPAR_NO_PALLAS_DENSE", "GPAR_PALLAS_DENSE_INTERPRET"):
        os.environ.pop(var, None)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             root: Path = ROOT, t0: float = None) -> dict:
    """Set up, run the window, check; the result object (without the
    device record's card fields when ``device`` is the CPU)."""
    import torch

    from portbench import cells, compare
    from portbench.trace import breakdown, traced

    t0 = T0 if t0 is None else t0
    cell = cells.resolve(workload, root)
    loop = cells.load_module(cell.paths["loop"])
    ref = cells.load_module(cell.paths["reference"])
    run = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    entered = time.perf_counter()
    st = loop.setup(run)
    setup_s = time.perf_counter() - t0
    log(f"[{workload}] set-up by stage, s from the start: imports {entered - t0:.3f}; "
        + "; ".join(f"{name} {at - t0:.3f}" for name, at in st.stages))
    if trace:
        win = loop.traced_window(run, st, traced)
        ctx = win["context"]
        metrics = {}
        for m in cell.per_layer:
            value = cells.load_module(cell.paths[m["name"]]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        win = loop.window(run, st)
        metrics = {m["name"]: {"value": cells.value_of(m["name"], win["metrics"]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    log(f"[{workload}] seed {seed}: set-up {setup_s:.3f} s; {win['notes']}")
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    loop.release(st)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = loop.check(run, st, ref)
    log(f"[{workload}] reference check {time.perf_counter() - t_ref:.3f} s")
    correct = compare.verdict(numbers, cell.limits)
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name() if torch.device(device).type == "cuda"
                                  else "cpu"),
                         "count": cell.workload["chips"], "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = ctx["trace"].busy_s
        result["device"]["window_s"] = ctx["trace"].window_s
        result["breakdown"] = breakdown(ctx["trace"], ctx["host_trace"])
    result["checks"] = {k: {"value": numbers.get(k), "limit": lim} for k, lim in cell.limits.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    import torch

    from portbench import cells

    chips = cells.resolve(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[portbench] needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    torch.set_num_threads(2)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"[portbench] loaded after the window: {', '.join(bad)}: no result")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
