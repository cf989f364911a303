"""The whole single long-series request's share of the card's float32
peak: ``predict_scaled``'s operations counted from shapes
(roofline/predict_scan.py, one draw) over the wall time a request takes
untraced, when the traced requests ran under the program's span
``gpar.predict``."""

from portbench.roofline import peaks, predict_scan


def read(ctx):
    st = ctx.get("span_trace")
    if st is None or not any("gpar.predict" in p for p in st.paths) or ctx["requests"] <= 0:
        return None
    flops = predict_scan.request_flops(ctx["b"], ctx["n"], ctx["n_star"], ctx["M"], ctx["D"], ctx["d"])
    return 100.0 * flops / (ctx["plain_s"] / ctx["requests"] * peaks()["f32_flop_per_s"])
