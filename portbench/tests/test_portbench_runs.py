"""Each cell's window loop and its comparison with the reference, driven at
a tiny size through the port's plain path on the CPU (the card's kernels
have CPU versions); each fault a cell can have, planted in the program
underneath the timed path, turns ``correct`` false; and the entry point
refuses to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import faults
from portbench.run import run_cell
from portbench.tests.helpers import REPO, tiny_copy

SEED = 2**33 + 5  # a large seed, past 32 signed bits


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("portbench"))


CELLS = ["dtc_m32-train-n1m", "eeg_m156-serve-b200", "dtc_m32-train-n10m"]

# Numbers whose limit holds only at the cell's own size.  The 10^7 cell's
# change_gap limit was set from readings of about 1e-6 at 10^7 steps on the
# card; at 3,000 steps a leaf whose gradient is a thousandth of the others'
# carries float32's rounding of it through Adam's second step, and the
# program and the reference differ by 1e-4 there on every seed.  Such a
# number is still computed and has to be finite.
AT_CELL_SIZE_ONLY = {"dtc_m32-train-n10m": {"change_gap"}}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_on_the_plain_path(root, workload, trace):
    r = run_cell(workload, SEED, 0.5, trace, "cpu", root=root)
    skip = AT_CELL_SIZE_ONLY.get(workload, set())
    assert all(c["value"] is not None and c["value"] == c["value"] for c in r["checks"].values())
    assert all(c["value"] <= c["limit"] for k, c in r["checks"].items() if k not in skip), r["checks"]
    assert r["correct"] or skip, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        # nothing runs on a device here: the device readers find nothing
        assert r["metrics"].get("scan_launches_per_step.train") is None
        assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    else:
        assert r["metrics"]["setup_s"]["value"] > 0
        assert len(r["metrics"]) >= 2
    assert list(r)[-1] == "checks"


FAULTS = [(w, f) for w in CELLS[:2]
          for f in (faults.TRAIN if "train" in w else faults.SERVE)]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_fault_makes_the_run_incorrect(root, workload, fault):
    table = faults.TRAIN if "train" in workload else faults.SERVE
    with table[fault]():
        r = run_cell(workload, SEED + 1, 0.5, False, "cpu", root=root)
    assert not r["correct"], r["checks"]


def test_entry_point_needs_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_entry_point_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, nothing runs."""
    tiny_copy(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
