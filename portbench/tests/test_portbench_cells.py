"""Every cell resolves by name to its files, and a cell added as files only
is found without editing any file."""

import json
import shutil

import pytest

from portbench import cells
from portbench.tests.helpers import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = cells.resolve(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.paths["loop"].is_file() and cell.paths["reference"].is_file()
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(cells.load_module(cell.paths[m["name"]]).read)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_suffixed_metric_falls_back_to_its_quantity():
    assert cells.quantities("mfu_pct.train.n10m") == ["mfu_pct.train.n10m", "mfu_pct.train", "mfu_pct"]
    cell = cells.resolve("dtc_m32-train-n10m")
    assert cell.paths["mfu_pct.train.n10m"].name == "mfu_pct.train.py"
    assert cells.value_of("train_step_ms.n10m", {"train_step_ms": 3.0}) == 3.0
    assert cells.value_of("train_step_ms", {"train_step_ms": 3.0, "train_step_ms.n10m": 4.0}) == 3.0
    with pytest.raises(KeyError):
        cells.value_of("obs_per_s", {"train_step_ms": 3.0})


def test_contract_shapes():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cell_added_as_files_only(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    mix = dict(json.loads((REPO / "portbench/traffic/train-n1m.json").read_text()), n=4_000_000)
    (tmp_path / "portbench/traffic/train-n4m.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/limits/dtc_m32-train-n4m.json").write_text(
        (REPO / "portbench/limits/dtc_m32-train-n1m.json").read_text())
    bench["workloads"].append({"name": "dtc_m32-train-n4m", "config": "gpar_dtc_m32",
                               "traffic": "train-n4m", "chips": 1, "why": "a later cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dtc_m32-train-n1m" in m.get("workloads", ()):
            m["workloads"].append("dtc_m32-train-n4m")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.resolve("dtc_m32-train-n4m", tmp_path)
    assert cell.traffic["n"] == 4_000_000
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in cells.resolve("dtc_m32-train-n1m").per_layer}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_missing_file_is_named(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    (tmp_path / "portbench/limits/eeg_m156-serve-b200.json").unlink()
    with pytest.raises(FileNotFoundError, match="limits"):
        cells.resolve("eeg_m156-serve-b200", tmp_path)
