"""Device milliseconds a batched long-series request under the program's
span ``gpar.request.smooth``: the smoother of the draws' columns (the
kernels K1 to K4b and the smoothing elements around them)."""


def read(ctx):
    st, n = ctx.get("span_trace"), ctx["requests"]
    if st is None or n <= 0 or not any("gpar.request.smooth" in p for p in st.paths):
        return None
    return 1e3 * st.device_s("gpar.request", "gpar.request.smooth") / n
