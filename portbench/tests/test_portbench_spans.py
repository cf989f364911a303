"""The attribution of device records to the program's spans and the
readings taken from it (``portbench/spans.py``), on hand-made profiler
records; and, on the card, that the program's host-sync counter sees every
synchronization that PyTorch's sync debug mode reports."""

import warnings

import pytest

from portbench import cells, spans
from portbench.spans import Rec
from portbench.trace import Trace

MAIN, WORKER = 1, 2


def span(name, thread, s, e, corr):
    return Rec(name, False, True, thread, s, e, corr, 0)


def op(name, thread, s, e, corr):
    return Rec(name, False, False, thread, s, e, corr, 0)


def launch(thread, t, corr, linked=0):
    return Rec("cudaLaunchKernel", False, False, thread, t, t + 1, corr, linked)


def kernel(name, s, e, corr, linked=0):
    return Rec(name, True, False, 0, s, e, corr, linked)


# Two Adam steps on the main thread; the second's backward runs on
# autograd's worker thread.  Times in ns; the device runs behind the host,
# so no kernel overlaps in time the span that launched it.
RECS = [
    span("gpar.fit", MAIN, 0, 10_000, 1),
    span("gpar.step", MAIN, 100, 4_000, 2),
    span("gpar.discretize", MAIN, 200, 1_000, 3),
    op("aten::mul", MAIN, 300, 400, 4),
    launch(MAIN, 350, 501, linked=4),
    span("gpar.whiten_gram", MAIN, 1_000, 2_000, 5),
    launch(MAIN, 1_500, 502),  # a ctypes launch: no PyTorch operation open
    span("gpar.backward", MAIN, 2_000, 3_900, 6),
    span("gpar.whiten_gram.backward", WORKER, 2_100, 3_800, 7),
    op("aten::bmm", WORKER, 2_200, 2_300, 8),
    launch(WORKER, 2_250, 503, linked=8),
    op("aten::add", WORKER, 3_850, 3_880, 9),  # worker, outside its own span
    launch(WORKER, 3_860, 504, linked=9),
    span("gpar.update", MAIN, 3_900, 4_000, 10),
    op("aten::norm", MAIN, 3_910, 3_990, 11),
    span("gpar.step", MAIN, 4_000, 8_000, 12),
    span("gpar.discretize", MAIN, 4_100, 5_000, 13),
    op("aten::exp", MAIN, 4_200, 4_300, 14),  # its runtime record was lost: found by ``linked``
    op("aten::neg", MAIN, 5_500, 5_600, 17),  # in the step, in none of its stages
    launch(MAIN, 5_550, 508, linked=17),
    op("aten::sum", MAIN, 9_000, 9_100, 15),
    launch(MAIN, 9_050, 506, linked=15),
    op("aten::copy_", MAIN, 10_500, 10_600, 16),  # after the fit: in no span
    launch(MAIN, 10_550, 507, linked=16),
    # device records, late; correlation ids 501.. collide with nothing above
    kernel("mul_kernel", 20_000, 21_000, 501, 4),
    kernel("phase1_kernel", 21_000, 24_000, 502),
    kernel("bmm_kernel", 24_000, 30_000, 503, 8),
    kernel("add_kernel", 30_000, 30_500, 504, 9),
    kernel("exp_kernel", 31_000, 32_000, 505, 14),
    kernel("sum_kernel", 32_000, 32_200, 506, 15),
    kernel("copy_kernel", 33_000, 33_300, 507, 16),
    kernel("neg_kernel", 34_000, 34_100, 508, 17),
    # the gpu_user_annotation copy of a span: not device work
    Rec("gpar.step", True, True, 0, 20_000, 30_500, 2, 0),
]


def _span_trace():
    device, host, paths, sps = spans.attribute(RECS)
    busy = sum(e - s for _, s, e in device) / 1e6
    return spans.SpanTrace(Trace(window_s=40e-6, busy_s=busy, device=device, host=host), paths, sps)


def test_paths_follow_the_launch_not_the_clock():
    st = _span_trace()
    names = [n for n, _, _ in st.trace.device]
    assert "gpar.step" not in names and len(names) == 8
    assert dict(zip(names, st.paths)) == {
        "mul_kernel": ("gpar.fit", "gpar.step", "gpar.discretize"),
        "phase1_kernel": ("gpar.fit", "gpar.step", "gpar.whiten_gram"),
        "bmm_kernel": ("gpar.fit", "gpar.step", "gpar.backward", "gpar.whiten_gram.backward"),
        "add_kernel": ("gpar.fit", "gpar.step", "gpar.backward"),
        "exp_kernel": ("gpar.fit", "gpar.step", "gpar.discretize"),
        "sum_kernel": ("gpar.fit",),
        "copy_kernel": (),
        "neg_kernel": ("gpar.fit", "gpar.step"),
    }
    assert st.trace.device[0] == ("mul_kernel", 20.0, 21.0)  # microseconds
    assert ("gpar.backward", 2.0, 3.9) in st.trace.host
    assert ("gpar.whiten_gram.backward", WORKER, 2.1, 3.8) in st.spans and len(st.spans) == 9


def test_device_time_under_spans_and_coverage():
    st = _span_trace()
    assert st.device_s("gpar.step", "gpar.discretize") == pytest.approx(2000e-9)
    assert st.device_s("gpar.step", "gpar.backward") == pytest.approx(6500e-9)
    assert st.device_s("gpar.whiten_gram") == pytest.approx(3000e-9)
    assert st.device_s("gpar.backward", "gpar.step") == 0.0  # nested in that order only
    total = 1000 + 3000 + 6000 + 500 + 1000 + 200 + 300 + 100
    assert st.covered_share() == pytest.approx((total - 300) / total)
    # under gpar.step every record but neg_kernel sits in a stage span
    assert st.stage_share("gpar.step") == pytest.approx(1 - 100 / 11600)


def test_readers_per_step_and_per_batch():
    st = _span_trace()
    ctx = {"span_trace": st, "host_syncs": 15, "steps": 2}
    got = spans.readings("train", ctx)
    assert got == pytest.approx({
        "host_syncs_per_step.train": 7.5, "discretize_ms_per_step.train": 1e-3,
        "whiten_ms_per_step.train": 1.5e-3, "backward_ms_per_step.train": 3.25e-3})
    assert spans.readings("serve", {"span_trace": st, "host_syncs": 3, "batches": 3}) == {
        "host_syncs_per_request.serve": 1.0, "condition_ms_per_request.serve": 0.0}
    # nothing to read: no span in the trace (a program without spans), no counter
    bare = spans.SpanTrace(st.trace, [()] * len(st.paths), [])
    assert spans.readings("train", {"span_trace": bare, "host_syncs": None, "steps": 2}) == {
        "host_syncs_per_step.train": None, "discretize_ms_per_step.train": None,
        "whiten_ms_per_step.train": None, "backward_ms_per_step.train": None}


def test_idle_gaps_by_span():
    """Each idle gap of the device goes to the innermost span open at its
    middle on any thread, else to ``python``."""
    sps = [("gpar.fit", MAIN, 0.0, 100.0), ("gpar.step", MAIN, 10.0, 90.0),
           ("gpar.whiten_gram.backward", WORKER, 40.0, 60.0)]
    device = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 55.0), ("k", 95.0, 100.0),
              ("k", 120.0, 125.0)]
    host = [(n, s, e) for n, _, s, e in sps] + [("aten::copy_", 110.0, 112.0)]
    st = spans.SpanTrace(Trace(125e-6, 40e-6, device, host), [()] * len(device), sps)
    idle = st.idle_by_span()
    assert dict(idle) == pytest.approx({"gpar.step": 50e-6, "gpar.whiten_gram.backward": 20e-6,
                                        "python": 20e-6})
    assert spans.python_share(idle) == pytest.approx(20 / 90)


def _readings(tr):
    """Every accepted per-layer reading of the 10^6 training cell from a
    context holding ``tr``."""
    ctx = {"trace": tr, "host_trace": tr, "plain_s": 50e-6, "steps": 2, "fits": 1, "n": 1000,
           "M": 32, "D": 2, "d": 3, "launches": {"K1": 1, "K2": 0, "K3": 0, "K4a": 0, "K4b": 0}}
    out = {}
    for m in cells.load_benchmark()["per_layer"]:
        if "dtc_m32-train-n1m" in m.get("workloads", ()):
            path = next(p for p in (cells.HERE / "metrics" / f"{q}.py"
                                    for q in cells.quantities(m["name"])) if p.is_file())
            out[m["name"]] = cells.load_module(path).read(ctx)
    return out


def test_existing_readers_read_a_span_trace_as_a_trace():
    """The annotation copies stay out of the device records, so every
    reader of the accepted per-layer metrics reads from a span trace what
    it reads from the trace of the same work without spans; kept in, the
    copy would count as device time."""
    st = _span_trace()
    dev = [(r.name, r.start_ns / 1e3, r.end_ns / 1e3) for r in RECS if r.on_device]
    plain = Trace(st.trace.window_s, st.trace.busy_s,
                  [d for d, r in zip(dev, [r for r in RECS if r.on_device]) if not r.annotation], [])
    got = _readings(st.trace)
    assert got == _readings(plain) and len(got) == 5
    with_copy = Trace(st.trace.window_s, st.trace.busy_s, dev, [])
    assert _readings(with_copy)["tensor_ms_per_step.train"] > got["tensor_ms_per_step.train"]


def test_host_sync_counter_is_complete(card):
    """One fit at N = 10^5 (3 Adam steps, the kernel path) and one batched
    request: PyTorch's sync debug mode warns once for each synchronization;
    the program's counter has counted each one."""
    import torch

    from gpar_at_scale_torch.config import get_config, kernel_family
    from gpar_at_scale_torch.gp import dtc
    from gpar_at_scale_torch.models import gpar
    from gpar_at_scale_torch.ssm.markov import lgssm_of
    from gpar_at_scale_torch.utils import observability as obs
    from gpar_at_scale_torch.utils.params import unpack_gpar
    from portbench.data import eeg_synth, million_dtc

    gen = torch.Generator(device=card).manual_seed(3)
    d = million_dtc.make(100_000, gen)
    fam = kernel_family("Matern52")
    cfg = gpar.GPARConfig(time_family=fam, out_family=fam, backend="scaled", filter_impl="pallas",
                          num_pseudo_points=32, dtype=torch.float32, optimizer="adam", max_opt_steps=3)
    x0 = torch.log(torch.tensor([0.5, 1.0, 1.0, 0.7, 0.2], device=card) - 1e-3)
    get_config().engine.pallas_dense = "off"
    e = eeg_synth.make(156, 100, 6, gen, torch.float32)

    def kernels(p):
        tl, ts, ol, osig, ns = unpack_gpar(p)
        return fam(lengthscale=tl, variance=ts**2), fam(lengthscale=ol, variance=osig**2), ns**2

    tk, ok, nv = kernels(torch.tensor([0.11, 0.31, 2.03, -1.29, -2.57], device=card))
    with torch.no_grad():
        qu = dtc.compute_q_u(ok, lgssm_of(tk, e.t, nv, torch.float32), e.X, e.X, e.y, uu_ridge=nv,
                             filter_fn="dense", time_kernel=tk, t=e.t)
    draws = torch.tensor([0.11, 0.31, 2.03, -1.29, -2.57], device=card) + 1e-3 * torch.randn(
        200, 5, generator=gen, device=card)
    btk, bok, bnv = kernels(draws.T)

    def work():
        gpar.fit_conditional(None, d.t, d.X, d.y, cfg, init_params=x0, device=card)
        with torch.no_grad():
            dtc.predict_scaled_batch(bok, btk, qu, e.X, e.t, e.y, e.t_star, e.X_star, bnv,
                                     dtype=torch.float32)

    work()  # builds the kernels and warms every shape
    torch.cuda.synchronize()
    before = obs.counts()["host_syncs"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counted = obs.counts()["host_syncs"] - before
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == counted and counted > 0
