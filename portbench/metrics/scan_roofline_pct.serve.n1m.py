"""The scan kernels' share of their least time in the batched long-series
request: the least time of every K1 to K4b launch under the span
``gpar.request.smooth`` at its shapes (roofline/scan.py: the larger of its
bytes at the HBM bandwidth and its operations at the float32 rate), over
the device time of their records, in %.

One pass of the smoother is one launch of each over the draws' series
laid end to end, b n_all steps with C = M + 1 columns: K2 writes the
gains and the filtered moments, K3 its filtered means.  More passes than
requests (draws in chunks) share the steps evenly."""

from portbench.roofline import least_s, scan

NAMES = tuple(frag for parts in scan.DEVICE_KERNELS.values() for frag, _ in parts)
SPAN = "gpar.request.smooth"


def read(ctx):
    st, L = ctx.get("span_trace"), ctx["launches"]
    if st is None or L.get("K1", 0) <= 0:
        return None
    device_s = sum(e - s for (name, s, e), p in zip(st.trace.device, st.paths)
                   if SPAN in p and any(f in name for f in NAMES)) / 1e6
    if device_s <= 0:
        return None
    d, C = ctx["d"], ctx["M"] + 1
    n = ctx["b"] * (ctx["n"] + ctx["n_star"]) * ctx["requests"] / L["K1"]  # steps a pass
    nb = scan.num_blocks(int(n))
    least = (L["K1"] * least_s(*scan.k1(n, d, nb)) + L["K2"] * least_s(*scan.k2(n, d, nb))
             + L["K3"] * least_s(*scan.k3(n, d, C, True))
             + L["K4a"] * least_s(*scan.k4a(n, d, C, nb)) + L["K4b"] * least_s(*scan.k4b(n, d, C, nb)))
    return 100.0 * least / device_s
