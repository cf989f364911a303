"""The program's spans in a profiler trace: every device record attributed
to the stages of the program that launched it, and the per-layer readings
taken from them.

The program names its stages with spans (``gpar_at_scale_torch/utils/
observability.py``: ``gpar.fit``, ``gpar.step``, ``gpar.discretize``, ...,
``gpar.request``, ``gpar.request.condition``, ...), off unless
``spans_on()``, and counts the places where the host waits for the device
(``observability.counts()["host_syncs"]``).  ``traced_spans(fn)`` runs fn
under torch.profiler, host and device, with the spans on, and gives each
device record the path of spans open at its launch.  The launch is found
through the profiler's correlation of the device record with the CUDA
runtime call that launched it (else with the PyTorch operation open then),
never by overlap in time: at N = 10^7 the device runs far behind the host.
A launch on autograd's worker thread goes under the spans of the thread
that traced fn open at that moment, followed by the worker's own.  The
``gpu_user_annotation`` copies of the spans on the device's timeline are
not device work and are left out of the device records.

    python -m portbench.spans --workload <cell> --seed <n> [--pairs 2] [--out FILE]

runs one cell's set-up, then reports on the card: the host syncs per step
(or per batch), a span-traced fit (or ``trace_batches`` batches) with the
readings of ``READERS``, how much of its device time the spans cover, the
idle gaps labelled by span, and the cost of the spans (the host-traced and
the untraced piece with spans on against off, in turns).  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
import time
from collections import defaultdict
from typing import NamedTuple

from portbench.stats import gaps, union_length
from portbench.trace import Trace

PREFIX = "gpar."
RUNTIME = re.compile(r"^cu(da)?[A-Z]")  # a CUDA API call on the host: cudaLaunchKernel, cuLaunchKernel, ...
STAGES = {"train": "gpar.step", "serve": "gpar.request"}


class Rec(NamedTuple):
    """One record of the profiler's raw event list."""

    name: str
    on_device: bool
    annotation: bool  # a record_function range, or its copy on the device's timeline
    thread: int
    start_ns: int
    end_ns: int
    corr: int  # a runtime call and the device records it launched share it
    linked: int  # the id (``corr``) of the PyTorch operation open at the call; 0 if none


class SpanTrace(NamedTuple):
    trace: Trace  # the window, device records (no annotation copies), host records (spans among them)
    paths: list  # for each of trace.device, the span names open at its launch, outermost first
    spans: list  # [(name, thread, start_us, end_us)] of the program's spans

    def device_s(self, *names) -> float:
        """Seconds of device time (summed) of the records launched inside
        every span of ``names``, nested in that order."""
        return sum(e - s for (_, s, e), p in zip(self.trace.device, self.paths)
                   if _nested(p, names)) / 1e6

    def covered_share(self) -> float:
        """Share of the device time launched inside some span."""
        total = self.trace.device_time()
        return sum(e - s for (_, s, e), p in zip(self.trace.device, self.paths) if p) / 1e6 / total \
            if total > 0 else 0.0

    def stage_share(self, parent: str) -> float:
        """The device time launched inside a span directly under
        ``parent``, over all the device time inside ``parent``."""
        whole = inner = 0.0
        for (_, s, e), p in zip(self.trace.device, self.paths):
            if parent in p:
                whole += e - s
                inner += (e - s) * (p.index(parent) + 1 < len(p))
        return inner / whole if whole > 0 else 0.0

    def idle_by_span(self, top: int = 10) -> list:
        """``Trace.idle_by_host`` with each of the longest idle gaps of the
        device labelled by the innermost span open at its middle (else
        ``python``), each [name, seconds]."""
        tr = self.trace
        spans_at = _opener(self.spans)
        lo = min([s for _, s, _ in tr.host] + [s for _, s, _ in tr.device], default=0.0)
        hi = max([e for _, _, e in tr.host] + [e for _, _, e in tr.device], default=0.0)
        by = defaultdict(float)
        for s, e in sorted(gaps([(s, e) for _, s, e in tr.device], lo, hi), key=lambda g: g[0] - g[1])[:500]:
            path = spans_at(None, 0.5 * (s + e))
            by[path[-1] if path else "python"] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def python_share(idle: list) -> float:
    """The share of ``python`` in the idle seconds of an ``idle_by_host``
    or ``idle_by_span`` list."""
    total = sum(v for _, v in idle)
    return sum(v for n, v in idle if n == "python") / total if total > 0 else 0.0


def _nested(path, names) -> bool:
    i = 0
    for n in path:
        if i < len(names) and n == names[i]:
            i += 1
    return i == len(names)


def _opener(spans):
    """``open_at(thread, t)``: the names of the spans open at time t on
    ``thread``, outermost first, behind those open then on the main
    thread (the one with the longest span) when ``thread`` is another;
    ``thread`` None asks every thread.  ``spans``: [(name, thread,
    start, end)]."""
    by_thread = defaultdict(list)
    for sp in sorted(spans, key=lambda sp: (sp[2], -sp[3])):
        by_thread[sp[1]].append(sp)
    main = max(spans, key=lambda sp: sp[3] - sp[2])[1] if spans else None
    order = [main] + [th for th in by_thread if th != main]

    def on(thread, t):
        return [n for n, _, s, e in by_thread.get(thread, ()) if s <= t <= e]

    def open_at(thread, t):
        if thread is None:
            return [n for th in order for n in on(th, t)]
        return (on(main, t) if thread != main else []) + on(thread, t)

    return open_at


def attribute(recs, start_ns: int = 0):
    """(device, host, paths, spans) from raw records: device records as
    [(name, start_us, end_us)] without the annotation copies, every host
    record likewise, times in microseconds from ``start_ns``; each device
    record's span path; the program's spans as [(name, thread, start_us,
    end_us)]."""
    us = lambda ns: (ns - start_ns) / 1e3  # noqa: E731
    runtime, ops, spans = {}, {}, []
    for r in recs:
        if r.on_device:
            continue
        if RUNTIME.match(r.name) and not r.annotation:
            runtime[r.corr] = r
        else:
            ops[r.corr] = r
            if r.annotation and r.name.startswith(PREFIX):
                spans.append((r.name, r.thread, r.start_ns, r.end_ns))
    open_at = _opener(spans)
    device, host, paths = [], [], []
    for r in recs:
        if not r.on_device:
            host.append((r.name, us(r.start_ns), us(r.end_ns)))
        elif not r.annotation:
            device.append((r.name, us(r.start_ns), us(r.end_ns)))
            launch = runtime.get(r.corr) or ops.get(r.linked)
            paths.append(() if launch is None else tuple(open_at(launch.thread, launch.start_ns)))
    return device, host, paths, [(n, th, us(s), us(e)) for n, th, s, e in spans]


def _raw(prof):
    """(records, start_ns) of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name  # the names prof.events() gives

    res = prof.profiler.kineto_results
    recs = []
    for ev in res.events():
        if ev.name() in ("[memory]", "[OutOfMemory]"):
            continue
        recs.append(Rec(_rewrite_name(ev.name(), with_wildcard=True), ev.device_type() == DeviceType.CUDA,
                        bool(ev.is_user_annotation()), int(ev.start_thread_id()), int(ev.start_ns()),
                        int(ev.end_ns()), int(ev.correlation_id()), int(ev.linked_correlation_id())))
    return recs, res.trace_start_ns()


def spans_on():
    """The program's ``spans_on()``, or a no-op where the program has no
    spans."""
    try:
        from gpar_at_scale_torch.utils.observability import spans_on as on
    except ImportError:
        return contextlib.nullcontext()
    return on()


def host_syncs():
    """The program's host-sync counter, or None where it has none."""
    try:
        from gpar_at_scale_torch.utils.observability import counts
    except ImportError:
        return None
    return counts()["host_syncs"]


def traced_spans(fn):
    """(fn's result, SpanTrace) of one call of fn under torch.profiler,
    host and device, with the program's spans on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=acts) as prof:
        with spans_on():
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
    device, host, paths, sps = attribute(*_raw(prof))
    busy = union_length([(s, e) for _, s, e in device]) / 1e6
    return out, SpanTrace(Trace(window_s=wall, busy_s=busy, device=device, host=host), paths, sps)


# ---------------------------------------------------------------------------
# The readings: ``ctx`` holds "span_trace", "host_syncs" (the counter's delta
# over the same work) and "steps" (training) or "batches" (serving)
# ---------------------------------------------------------------------------


def _per(ctx, unit):
    n = ctx.get(unit, 0)
    return None if n <= 0 else 1.0 / n


def _ms_under(ctx, unit, *names):
    per, st = _per(ctx, unit), ctx.get("span_trace")
    if per is None or st is None or not any(st.paths):
        return None
    return 1e3 * st.device_s(*names) * per


def _syncs(ctx, unit):
    per = _per(ctx, unit)
    return None if per is None or ctx.get("host_syncs") is None else ctx["host_syncs"] * per


READERS = {
    "host_syncs_per_step.train": lambda ctx: _syncs(ctx, "steps"),
    "discretize_ms_per_step.train": lambda ctx: _ms_under(ctx, "steps", "gpar.step", "gpar.discretize"),
    "whiten_ms_per_step.train": lambda ctx: _ms_under(ctx, "steps", "gpar.step", "gpar.whiten_gram"),
    "backward_ms_per_step.train": lambda ctx: _ms_under(ctx, "steps", "gpar.step", "gpar.backward"),
    "host_syncs_per_request.serve": lambda ctx: _syncs(ctx, "batches"),
    "condition_ms_per_request.serve": lambda ctx: _ms_under(ctx, "batches", "gpar.request",
                                                            "gpar.request.condition"),
}


def readings(kind: str, ctx) -> dict:
    """Every reading of ``READERS`` that applies to a ``kind`` ("train" or
    "serve") piece, None where its context holds nothing to read."""
    return {name: f(ctx) for name, f in READERS.items() if name.endswith("." + kind)}


def coverage(kind: str, st: SpanTrace) -> dict:
    """How much of the piece's device time the spans account for, and the
    share of its idle gaps with no span open."""
    return {"in_a_span": st.covered_share(), "in_a_stage": st.stage_share(STAGES[kind]),
            "python_idle_share": python_share(st.idle_by_span())}


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def _pieces(loop, st, kind):
    """(one piece of the cell's traced work, its units, the unit's name)."""
    if kind == "train":
        return st.fit, st.mix["steps_per_fit"], "steps"
    n = st.mix["trace_batches"]
    return (lambda: loop._serve(st, lambda c, s: c >= n)), n, "batches"


def measure(workload: str, seed: int, pairs: int, device: str = "cuda", root=None) -> dict:
    import torch

    from portbench import cells, trace
    from types import SimpleNamespace

    cell = cells.resolve(workload, *(() if root is None else (root,)))
    loop = cells.load_module(cell.paths["loop"])
    kind = "train" if cell.traffic["loop"] == "train_fits" else "serve"
    run = SimpleNamespace(cell=cell, seed=seed, seconds=0.0, device=device)
    st = loop.setup(run)
    piece, units, unit = _pieces(loop, st, kind)
    card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)

    before = host_syncs()
    piece()
    sync()
    after = host_syncs()
    syncs = None if before is None else after - before
    _, span_tr = traced_spans(piece)
    ctx = {"span_trace": span_tr, "host_syncs": syncs, unit: units}
    out = {"workload": workload, "seed": seed, "units": units, "unit": unit,
           "device": torch.cuda.get_device_name() if card else "cpu",
           "readings": readings(kind, ctx), "coverage": coverage(kind, span_tr),
           "idle_gaps_by_span": span_tr.idle_by_span(), "idle_gaps_by_host": span_tr.trace.idle_by_host(),
           "device_records": len(span_tr.trace.device)}
    _, plain_host = trace.traced(piece, host=True)
    out["idle_gaps_no_spans"] = plain_host.idle_by_host()
    out["python_idle_share_no_spans"] = python_share(out["idle_gaps_no_spans"])
    out["python_idle_share_by_host"] = python_share(out["idle_gaps_by_host"])
    stages, outside = defaultdict(float), defaultdict(float)
    for (name, s, e), p in zip(span_tr.trace.device, span_tr.paths):
        stages["/".join(p) or "(none)"] += (e - s) / 1e3
        if not p:
            outside[name] += (e - s) / 1e3
    out["device_ms_by_path"] = dict(sorted(stages.items(), key=lambda kv: -kv[1]))
    out["device_ms_outside_spans"] = dict(sorted(outside.items(), key=lambda kv: -kv[1])[:8])

    # the cost of the spans: host-traced and untraced pieces, spans on
    # against off, in turns (off, on, on, off, ...)
    cost = {"host_traced_off": [], "host_traced_on": [], "untraced_off": [], "untraced_on": []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with (spans_on() if on else contextlib.nullcontext()):
                _, tr = trace.traced(piece, host=True)
                cost["host_traced_" + ("on" if on else "off")].append(tr.window_s)
                sync()
                t0 = time.perf_counter()
                piece()
                sync()
                cost["untraced_" + ("on" if on else "off")].append(time.perf_counter() - t0)
    out["cost_s_per_piece"] = cost
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = p.parse_args(argv)
    from portbench.run import environment

    environment()
    import torch

    if not torch.cuda.is_available():
        print("[portbench.spans] needs a CUDA card: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = measure(args.workload, args.seed, args.pairs)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
