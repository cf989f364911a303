"""The whole training step's share of the card's float32 peak: the DTC
bound's value and gradient, counted from shapes (roofline/dtc_step.py),
plus each fit's q(u), over the wall time that the traced fit takes
untraced."""

from portbench.roofline import dtc_step, peaks


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    n, M, D, d = ctx["n"], ctx["M"], ctx["D"], ctx["d"]
    flops = ctx["steps"] * dtc_step.step_flops(n, M, D, d) + ctx["fits"] * dtc_step.qu_flops(n, M, D, d)
    return 100.0 * flops / (ctx["plain_s"] * peaks()["f32_flop_per_s"])
