"""Launches of the scan kernels K1 to K4b per Adam step in the traced
window, from the program's exact launch counters (ops.launch_counts)."""

KERNELS = ("K1", "K2", "K3", "K4a", "K4b")


def read(ctx):
    total = sum(ctx["launches"][k] for k in KERNELS)
    if total <= 0 or ctx["steps"] <= 0:
        return None
    return total / ctx["steps"]
