"""100 minus the union of device activity over the traced long-series
requests, in % of their traced wall time.  The device is busy through
nearly all of such a request, so the untraced time of as many requests,
which ``device_idle_pct.serve`` divides by, can fall below the traced busy
time and read a share under zero."""

from portbench.stats import idle_pct


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    return idle_pct(tr.busy_s, tr.window_s)
