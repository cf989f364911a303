"""The scan kernels' share of their least time: the least time of every
launch of K1 to K4b in the traced window at its shapes (roofline/scan.py:
the larger of its bytes at the HBM bandwidth and its operations at the
float32 rate), over the device time of their records, in %.

The device kernels are found by the names of ``scan.DEVICE_KERNELS``
(csrc/*.cu; K3 runs four per launch).  K3 stores its filtered means in
training's forward, which the backward (one K4a launch) reads: K4a's
launches count those sweeps."""

from portbench.roofline import least_s, scan

NAMES = tuple(frag for parts in scan.DEVICE_KERNELS.values() for frag, _ in parts)


def read(ctx):
    tr, L = ctx["trace"], ctx["launches"]
    device_s = tr.device_time(lambda name: any(f in name for f in NAMES))
    if device_s <= 0:
        return None
    n, d, B = ctx["n"], ctx["d"], ctx["M"] + 1
    nb = scan.num_blocks(n)
    with_means = L["K4a"]
    least = (L["K1"] * least_s(*scan.k1(n, d, nb)) + L["K2"] * least_s(*scan.k2(n, d, nb))
             + with_means * least_s(*scan.k3(n, d, B, True))
             + (L["K3"] - with_means) * least_s(*scan.k3(n, d, B, False))
             + L["K4a"] * least_s(*scan.k4a(n, d, B, nb)) + L["K4b"] * least_s(*scan.k4b(n, d, B, nb)))
    return 100.0 * least / device_s
