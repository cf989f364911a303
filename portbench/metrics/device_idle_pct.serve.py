"""100 minus the union of device activity over the traced serving batches,
in % of the wall time that as many batches take untraced."""

from portbench.stats import idle_pct


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    return idle_pct(tr.busy_s, ctx["plain_s"])
