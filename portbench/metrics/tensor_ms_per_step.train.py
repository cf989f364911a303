"""Device milliseconds per Adam step of every device operation that is not
one of the scan kernels K1 to K4b: the DTC conditional's tensor code
(discretization, K_fu, the Gram, the M x M algebra, the pullback)."""

from portbench.roofline.scan import DEVICE_KERNELS

SCAN_NAMES = tuple(frag for parts in DEVICE_KERNELS.values() for frag, _ in parts)


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or ctx["steps"] <= 0:
        return None
    other = tr.device_time(lambda name: not any(f in name for f in SCAN_NAMES))
    return 1e3 * other / ctx["steps"]
