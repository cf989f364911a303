"""The whole batched request's share of the card's float32 peak: the
batch's operations counted from shapes (roofline/predict_batch.py) over
the wall time that the traced work takes untraced."""

from portbench.roofline import peaks, predict_batch


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    flops = ctx["batches"] * predict_batch.batch_flops(ctx["b"], ctx["n"], ctx["n_star"],
                                                        ctx["M"], ctx["D"])
    return 100.0 * flops / (ctx["plain_s"] * peaks()["f32_flop_per_s"])
