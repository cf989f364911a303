"""No cell loads JAX or the JAX package, and no reference imports the
program.  Module names are compared by their top-level name, the part
before the first dot, whole: the port's name begins with the JAX
package's."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.run import FORBIDDEN
from portbench.tests.helpers import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())

PROBE = """
import json, sys
from portbench import cells, run
cell = cells.resolve(sys.argv[1])
cells.load_module(cell.paths["loop"])
cells.load_module(cell.paths["reference"])
for m in cell.per_layer:
    cells.load_module(cell.paths[m["name"]])
import portbench.calibrate, portbench.faults, portbench.trace
import gpar_at_scale_torch.models.gpar, gpar_at_scale_torch.gp.dtc, gpar_at_scale_torch.ops
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_no_jax(workload):
    p = subprocess.run([sys.executable, "-c", PROBE, workload], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "portbench" in top and "gpar_at_scale_torch" in top
    assert not top & set(FORBIDDEN), sorted(top & set(FORBIDDEN))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((REPO / "portbench/reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"gpar_at_scale_torch", "portbench", *FORBIDDEN}, tops


def test_harness_imports_no_jax_package():
    for path in (REPO / "portbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops)
        assert "benchmarks" not in tops and "bench" not in tops and "chip_smoke" not in tops
