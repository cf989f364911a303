"""The long-series serving cells, ``dtc_m32-serve-b64-n1m`` (64 draws a
request through ``predict_scaled_batch``'s scan branch) and
``dtc_m32-predict-n1m`` (one ``FittedConditional.predict`` a request; its
files are here, its entry in ``BENCHMARK.json`` waits until its spread
fits the bounds, and the tests add it to their copy): they resolve with
per-layer readers of their own; driven at a tiny size through the port's
plain path on the CPU they are correct, while the reference's control and
each planted fault, a fit that never moves among them, fail a limit;
their readers read a hand-made span trace; and their reference loads
neither JAX nor the program."""

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import cells, compare
from portbench.run import FORBIDDEN, run_cell
from portbench.spans import SpanTrace
from portbench.tests.helpers import REPO
from portbench.trace import Trace

CELLS = ["dtc_m32-serve-b64-n1m", "dtc_m32-predict-n1m"]
SEED = 2**33 + 7  # past 32 signed bits


def with_single(bench: dict) -> dict:
    """``bench`` with the single-request cell's entries, as the change that
    adds the cell to the benchmark would add them."""
    w = CELLS[1]
    bench["workloads"].append({"name": w, "config": "gpar_dtc_m32_serve", "traffic": "predict-n1m",
                               "chips": 1, "why": "one FittedConditional.predict a request"})
    next(m for m in bench["end_to_end"] if m["name"] == "obs_per_s")["workloads"].append(w)
    bench["per_layer"] += [{"name": name, "unit": unit, "better": better, "source": source,
                            "layer": layer, "moves": "obs_per_s", "workloads": [w]}
                           for name, unit, better, source, layer in (
                               ("mfu_pct.predict.n1m", "%", "higher", "device_trace", "single request"),
                               ("smooth_ms_per_request.predict.n1m", "ms", "lower", "program_span",
                                "smoother"),
                               ("device_idle_pct.predict.n1m", "%", "lower", "device_trace", "device"))]
    return bench


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """BENCHMARK.json, with the single-request cell, and portbench/ with the
    configuration cut to 3000 training and 100 held-out times, 8 draws."""
    dest = tmp_path_factory.mktemp("portbench_scan")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = with_single(json.loads((REPO / "BENCHMARK.json").read_text()))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    path = dest / "portbench/configs/gpar_dtc_m32_serve.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), n=3000, n_star=100, draws=8)))
    return dest


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_with_readers_of_its_own(root, workload):
    cell = cells.resolve(workload, REPO if "b64" in workload else root)
    assert cell.config["name"] == "gpar_dtc_m32_serve" and cell.traffic["loop"] == "serve_scan"
    assert {m["name"] for m in cell.end_to_end} >= {"obs_per_s", "setup_s"}
    assert ("request_p95_ms" in {m["name"] for m in cell.end_to_end}) == ("b64" in workload)
    assert len(cell.per_layer) >= 2
    for m in cell.per_layer:
        assert cell.paths[m["name"]].name == m["name"] + ".py"


@pytest.mark.parametrize("workload", CELLS)
def test_run_is_correct_on_the_plain_path(root, workload):
    r = run_cell(workload, SEED, 0.5, False, "cpu", root=root)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["obs_per_s"]["value"] > 0 and r["metrics"]["setup_s"]["value"] > 0


def test_traced_run_on_the_plain_path(root):
    """Nothing runs on a device here: the device readers find nothing."""
    r = run_cell(CELLS[0], SEED, 0.5, True, "cpu", root=root)
    assert r["correct"], r["checks"]
    assert r["metrics"] == {} and r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(root, workload):
    """The reference below the configuration's precision (float32, with
    TF32 matmuls where the card has them) in the program's place."""
    cell = cells.resolve(workload, root)
    loop = cells.load_module(cell.paths["loop"])
    ref = cells.load_module(cell.paths["reference"])
    run = SimpleNamespace(cell=cell, seed=SEED + 1, seconds=0.5, device="cpu")
    numbers = loop.control_numbers(run, loop.setup(run), ref)
    assert not compare.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "answer_altered", "state_unchanged"])
def test_fault_makes_the_run_incorrect(root, workload, fault):
    loop = cells.load_module(cells.resolve(workload, root).paths["loop"])
    with loop.FAULTS[fault]():
        r = run_cell(workload, SEED + 2, 0.5, False, "cpu", root=root)
    assert not r["correct"], r["checks"]


def _trace():
    """Two batched requests and two single ones, hand-made: each K1-K4b
    record 1 ms and one tensor-code record 2 ms under the smoother, one
    record outside it."""
    kernels = ["phase1_kernel", "phase3_kernel", "sweep_kernel", "sweep_kernel", "prefix_kernel",
               "ll_sum_kernel", "suffix_reduce_kernel", "suffix_replay_kernel"]
    device, paths = [], []
    for top in ("gpar.request", "gpar.predict"):
        for _ in range(2):
            t0 = device[-1][2] if device else 0.0
            for i, name in enumerate(kernels):
                device.append((name, t0 + 1e3 * i, t0 + 1e3 * (i + 1)))
                paths.append((top, top + ".smooth"))
            device.append(("elementwise_kernel", device[-1][2], device[-1][2] + 2e3))
            paths.append((top, top + ".smooth"))
            device.append(("gemm", device[-1][2], device[-1][2] + 5e3))
            paths.append((top, top + ".kernels"))
    busy = sum(e - s for _, s, e in device) / 1e6
    return SpanTrace(Trace(window_s=1.0, busy_s=busy, device=device, host=[]), paths, [])


def test_readers_on_a_synthetic_trace():
    st = _trace()
    ctx = {"span_trace": st, "trace": st.trace, "requests": 2, "plain_s": 4.0,
           "launches": {"K1": 2, "K2": 2, "K3": 2, "K4a": 2, "K4b": 2},
           "b": 64, "n": 10**6, "n_star": 10**4, "M": 32, "D": 2, "d": 3}
    read = {m: cells.load_module(REPO / f"portbench/metrics/{m}.py").read for m in (
        "mfu_pct.serve.n1m", "mfu_pct.predict.n1m", "scan_roofline_pct.serve.n1m",
        "smooth_ms_per_request.serve.n1m", "smooth_ms_per_request.predict.n1m")}
    assert read["smooth_ms_per_request.serve.n1m"](ctx) == pytest.approx(10.0)
    assert read["smooth_ms_per_request.predict.n1m"](ctx) == pytest.approx(10.0)
    from portbench.roofline import least_s, peaks, predict_scan, scan

    n, C = 64 * 1_010_000, 33
    nb = scan.num_blocks(n)
    least = sum(least_s(*x) for x in (scan.k1(n, 3, nb), scan.k2(n, 3, nb), scan.k3(n, 3, C, True),
                                      scan.k4a(n, 3, C, nb), scan.k4b(n, 3, C, nb)))
    assert read["scan_roofline_pct.serve.n1m"](ctx) == pytest.approx(100.0 * 2 * least / 16e-3)
    flops = predict_scan.request_flops(64, 10**6, 10**4, 32, 2)
    assert read["mfu_pct.serve.n1m"](ctx) == pytest.approx(100.0 * flops / (2.0 * peaks()["f32_flop_per_s"]))
    assert read["mfu_pct.predict.n1m"](ctx) == pytest.approx(100.0 * flops / (2.0 * peaks()["f32_flop_per_s"]))
    # batched: over the traced window (1 s here); single: over the untraced time (4 s)
    idle = {m: cells.load_module(REPO / f"portbench/metrics/device_idle_pct.{m}.n1m.py").read
            for m in ("serve", "predict")}
    assert idle["serve"](ctx) == pytest.approx(100.0 * (1.0 - st.trace.busy_s / 1.0))
    assert idle["predict"](ctx) == pytest.approx(100.0 * (1.0 - st.trace.busy_s / 4.0))
    # a program without the spans (the parent of the cells): nothing to read
    bare = dict(ctx, span_trace=SpanTrace(st.trace, [()] * len(st.paths), []))
    assert all(r(bare) is None for r in read.values())


PROBE = """
import json, sys
from portbench import cells
ref = cells.load_module(cells.resolve(sys.argv[1]).paths["reference"])
ref.q_u, ref.predict
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_reference_loads_neither_jax_nor_the_program():
    """Loaded as the harness loads it (with ``gpar_dtc_m32.py``'s helpers,
    which it loads by path), the serving reference brings in no module of
    JAX, of the JAX package or of the port."""
    p = subprocess.run([sys.executable, "-c", PROBE, CELLS[0]], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & {"gpar_at_scale_torch", *FORBIDDEN}, sorted(top)
