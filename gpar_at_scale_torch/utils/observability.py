"""Structured metrics, stage timers, spans, a host-sync counter and
profiler traces.

Counterpart of ``gpar_at_scale_tpu/utils/observability.py``: JSONL metric
records, wall-clock stage timers that wait for the device before they stop
(the counterpart of ``block_until_ready``) and a profiler trace, all from
rank 0 only under ``torch.distributed``.

Spans name the stages of the training step and of the batched request
(``gpar.fit``, ``gpar.step``, ``gpar.discretize``, ... ``gpar.request``,
``gpar.request.condition``, ...).  They are off by default, and then
``span`` returns one shared no-op context after one flag check.  Inside
``spans_on()`` (``profiler_trace`` turns them on for its block) each span
is a ``torch.profiler.record_function``, so it lands in the profiler's
trace on the clock of the device records, and the device work launched
inside it can be told apart by the stage that launched it.

``counts()`` reads the program's counters, always on: ``host_syncs``
counts the places on the fit and request paths where the host waits for
the device (a value read back, a factorization's info check, a blocking
copy to the card).  The same places count on CPU tensors, where nothing
waits.  Read it before and after a piece of work, as
``ops.launch_counts()``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


def host_zero() -> bool:
    """True on rank 0 of ``torch.distributed``, or without a process group."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


@dataclass
class MetricsLogger:
    """Append-only JSONL metric stream (a file and/or stderr), rank 0 only.

    Usage: ``log.record("fit", step=i, nlml=float(loss))``."""

    path: Optional[str] = None
    echo: bool = False
    _fh: Any = field(default=None, repr=False)
    _records: List[Dict] = field(default_factory=list, repr=False)

    def record(self, event: str, **fields):
        if not host_zero():
            return
        rec = {"event": event, "time": time.time(), **fields}
        self._records.append(rec)
        line = json.dumps(rec)
        if self.path:
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stderr)

    @property
    def records(self) -> List[Dict]:
        return self._records

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


_spans = False  # whether span() records
_OFF = contextlib.nullcontext()
_host_syncs = 0
_host_syncs_lock = threading.Lock()  # autograd's worker threads count too


def span(name: str):
    """A context naming a stage of the program: the shared no-op context
    while spans are off; inside ``spans_on()`` a
    ``torch.profiler.record_function(name)``."""
    if not _spans:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans_on():
    """Turn the program's spans on for the block."""
    global _spans
    before = _spans
    _spans = True
    try:
        yield
    finally:
        _spans = before


def host_sync() -> None:
    """Count one place where the host waits for the device."""
    global _host_syncs
    with _host_syncs_lock:
        _host_syncs += 1


def counts() -> Dict[str, int]:
    """The program's counters since the process started:
    ``{"host_syncs": n}``."""
    return {"host_syncs": _host_syncs}


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def synchronize(tree) -> None:
    """Wait until the devices of every tensor in ``tree`` have finished
    their queued work (CUDA tensors; CPU tensors are ready)."""
    for dev in {x.device for x in _tensors(tree)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage_timer(name: str, logger: Optional[MetricsLogger] = None, sync: Any = None):
    """Wall-clock a stage.  ``sync`` (a tensor or a tree of tensors), or
    ``holder["sync"]`` set inside the block, is synchronized before the
    clock stops, so the device work it depends on is counted.  It
    synchronizes: it must not wrap hot-path code (``span`` does not wait).  The seconds
    land in ``holder["seconds"]`` and in ``logger`` (else on stderr, rank 0
    only)."""
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        synchronize(sync if sync is not None else holder.get("sync"))
        dt = time.perf_counter() - t0
        holder["seconds"] = dt
        if logger is not None:
            logger.record("stage", name=name, seconds=dt)
        elif host_zero():
            print(f"[{name}] {dt:.3f}s", file=sys.stderr)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block (CPU and, with a card,
    CUDA activity), with the program's spans on, and write it as a Chrome
    trace ``trace.json`` under ``log_dir``, on rank 0; does nothing without
    a directory."""
    if not log_dir or not host_zero():
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof, spans_on():
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
