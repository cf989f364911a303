"""The batched predictive's dense algebra against its least time: the
batches' factorizations, solves and products at the float32 rate
(roofline/predict_batch.py), over the device's busy time inside the
batch calls (the traced window holds nothing else), in %."""

from portbench.roofline import peaks, predict_batch


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    flops = ctx["batches"] * predict_batch.batch_flops(ctx["b"], ctx["n"], ctx["n_star"],
                                                        ctx["M"], ctx["D"])
    return 100.0 * flops / peaks()["f32_flop_per_s"] / tr.busy_s
