"""The arithmetic of the window rate, the p95 over all requests, the idle
share from a synthetic timeline, and the scan kernels' least times, which
must reproduce the bound column of PERF.md's kernel table (N = 1e6, d = 3,
16384 blocks, 33 columns)."""

import pytest

from portbench import stats
from portbench.roofline import dtc_step, least_s, predict_batch, scan
from portbench.trace import Trace, breakdown


def test_window_rate_and_step_time():
    assert stats.rate(20_000 * 600, 3.0) == pytest.approx(4.0e6)
    assert stats.per_unit_ms(30.0, 400) == pytest.approx(75.0)
    with pytest.raises(ValueError):
        stats.per_unit_ms(30.0, 0)


def test_p95_over_all_requests():
    lat = [0.005] * 950 + [0.009] * 50
    assert stats.percentile(lat, 95) == 0.005
    assert stats.percentile(lat + [0.009], 95) == 0.009
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([7.0], 95) == 7.0


def test_idle_share_from_a_timeline():
    spans = [(0, 10), (5, 20), (30, 40), (39, 41), (60, 70)]
    assert stats.union_length(spans) == 20 + 11 + 10
    assert stats.gaps(spans, 0, 100) == [(20, 30), (41, 60), (70, 100)]
    assert stats.idle_pct(41e-6, 100e-6) == pytest.approx(59.0)
    tr = Trace(window_s=100e-6, busy_s=stats.union_length(spans) / 1e6,
               device=[("gemm", 0, 10), ("gemm", 5, 20), ("phase1_kernel", 30, 40),
                       ("copy", 39, 41), ("phase3_kernel", 60, 70)],
               host=[("python", 0, 100), ("aten::item", 20, 31), ("cudaStreamSynchronize", 41, 60)])
    b = breakdown(tr, tr)
    assert b["device_ops"][0] == ["gemm", pytest.approx(25e-6)]
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"aten::item": 10e-6, "cudaStreamSynchronize": 19e-6, "python": 30e-6})
    assert tr.count("phase") == 2
    # the device ops come from the device-only trace, the idle gaps' labels
    # from the one that recorded the host
    bare = tr._replace(host=[])
    b = breakdown(tr, bare)
    assert b["device_ops"][0] == ["gemm", pytest.approx(25e-6)]
    assert dict(b["idle_gaps"]) == pytest.approx({"python": 29e-6})


@pytest.mark.parametrize("kernel, ms", [
    ("K1", 0.0245), ("K2", 0.0445), ("K3", 0.1003), ("K3 means", 0.2185),
    ("K4a", 0.1420), ("K4b", 0.2708)])
def test_scan_bounds_reproduce_the_kernel_table(kernel, ms):
    n, d, B = 10**6, 3, 33
    nb = scan.num_blocks(n)
    assert nb == 16384
    counts = {"K1": scan.k1(n, d, nb), "K2": scan.k2(n, d, nb), "K3": scan.k3(n, d, B, False),
              "K3 means": scan.k3(n, d, B, True), "K4a": scan.k4a(n, d, B, nb),
              "K4b": scan.k4b(n, d, B, nb)}
    assert round(1e3 * least_s(*counts[kernel]), 4) == ms


def test_step_and_batch_counts():
    # about 9 GFLOP a training step at N = 1e6, M = 32 (the float64 Gram
    # and its cotangent 2 x 2.2 of it)
    assert dtc_step.step_flops(10**6, 32, 2) == pytest.approx(8.85e9)
    assert 2 * 2 * 10**6 * 33**2 < dtc_step.step_flops(10**6, 32, 2)
    assert predict_batch.batch_flops(200, 156, 100, 156, 6) == pytest.approx(13.55e9, rel=1e-3)
