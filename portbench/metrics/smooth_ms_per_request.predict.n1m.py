"""Device milliseconds a single long-series request under the program's
span ``gpar.predict.smooth``: ``predict_scaled``'s smoother of its M + 1
columns."""


def read(ctx):
    st, n = ctx.get("span_trace"), ctx["requests"]
    if st is None or n <= 0 or not any("gpar.predict.smooth" in p for p in st.paths):
        return None
    return 1e3 * st.device_s("gpar.predict", "gpar.predict.smooth") / n
