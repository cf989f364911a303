"""The traced window: torch.profiler over a bounded piece of work, reduced to
the device's busy time (the union of device activity), its operations by
name, and the host's doing in the longest idle gaps.

The busy, idle and wall figures come from a trace of the device's activity
alone: recording the host's operations as well stretches the work it
traces (a fit at 10^6 by up to three quarters).  What the host does in the idle
gaps is read from a second trace, of a like piece of work, that records
both.

Kept short on purpose (one fit, or a few dozen batches): torch.profiler
has lost device records late in long traced processes, so the caller also
compares the trace's count of the scan kernels with the program's launch
counters.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

from portbench.stats import gaps, union_length


class Trace(NamedTuple):
    window_s: float  # host wall time of the traced work, synchronized at both ends
    busy_s: float  # union of device activity inside it
    device: list  # [(name, start_us, end_us)] of every device kernel, copy and set
    host: list  # [(name, start_us, end_us)] of the host's operations

    def device_time(self, match=lambda name: True) -> float:
        """Seconds of device time (summed, not unioned) of the records
        whose name passes ``match``."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def count(self, fragment: str) -> int:
        return sum(1 for n, _, _ in self.device if fragment in n)

    def top_ops(self, top: int = 10) -> list:
        """The device operations that took most time, each [name, seconds]."""
        by_name = defaultdict(float)
        for n, s, e in self.device:
            by_name[n] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_by_host(self, top: int = 10) -> list:
        """The longest idle gaps of the device, summed by what the host was
        doing in them (the latest host operation still open at a gap's
        middle, else ``python``), each [name, seconds]."""
        spans = [(s, e) for _, s, e in self.device]
        lo = min([s for _, s, _ in self.host] + [s for s, _ in spans], default=0.0)
        hi = max([e for _, _, e in self.host] + [e for _, e in spans], default=0.0)
        idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:500]
        host = sorted(self.host, key=lambda r: r[1])
        starts = [s for _, s, _ in host]
        by_doing = defaultdict(float)
        for s, e in idle:
            mid = 0.5 * (s + e)
            label = "python"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 2000, -1), -1):  # the latest host op still open
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            by_doing[label] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by_doing.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(device_trace: Trace, host_trace: Trace) -> dict:
    """The result line's ``breakdown``: the device operations of the
    device-only trace and the idle gaps of the trace with the host's
    operations."""
    return {"device_ops": device_trace.top_ops(), "idle_gaps": host_trace.idle_by_host()}


def traced(fn, host: bool = False):
    """(fn's result, Trace) of one call of fn under torch.profiler: the
    device's activity, and with ``host`` the host's operations too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = ([ProfilerActivity.CPU] if host else []) + ([ProfilerActivity.CUDA] if card else [])
    sync()
    if not acts:  # nothing to record: no card and no host trace asked for
        t0 = time.perf_counter()
        out = fn()
        return out, Trace(window_s=time.perf_counter() - t0, busy_s=0.0, device=[], host=[])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    device, host_ops = [], []
    for ev in prof.events():
        rec = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            device.append(rec)
        elif host:
            host_ops.append(rec)
    busy = union_length([(s, e) for _, s, e in device]) / 1e6
    return out, Trace(window_s=wall, busy_s=busy, device=device, host=host_ops)
