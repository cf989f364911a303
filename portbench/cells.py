"""Find a cell's files by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
per-layer metric names itself.  Everything else is found from those names:

    configs/<config>.json        the configuration, as run (its ``file``)
    reference/<config>.py        its plain reference
    traffic/<traffic>.json       the traffic mix: parameters only; its
                                 ``loop`` names the general generator
    loops/<loop>.py              the window loop of a kind of traffic
    limits/<workload>.json       the limits of the numbers compared
    metrics/<metric>.py          the reader of one per-layer metric

so a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.  A metric named ``<quantity>.<suffix>`` with no
reader of its own is read by the reader of ``<quantity>``, and an
end-to-end one takes the value that a loop reports as ``<quantity>``: the
same quantity in cells that need bounds of their own (``train_step_ms``
and ``train_step_ms.n10m``) needs no new code.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    workload: dict  # the entry of BENCHMARK.json's "workloads"
    config: dict  # the parsed configuration file
    traffic: dict  # the parsed traffic mix
    limits: dict  # {number compared: limit}
    end_to_end: list  # the entries of "end_to_end" that this cell reports
    per_layer: list  # the entries of "per_layer" that this cell reports
    paths: dict  # {"config", "traffic", "loop", "reference", "limits", metric name: Path}


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str, e2e_names=None) -> bool:
    """A metric with ``workloads`` is reported in those cells; a per-layer
    metric without it in every cell that reports the metric it moves; an
    end-to-end metric without it in every cell."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with every file it needs; raises KeyError or
    FileNotFoundError naming what is missing."""
    bench = load_benchmark(root)
    here = root / "portbench"
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    paths = {
        "config": root / cfg_entry["file"],
        "reference": here / "reference" / f"{w['config']}.py",
        "traffic": here / "traffic" / f"{w['traffic']}.json",
        "limits": here / "limits" / f"{name}.json",
    }
    traffic = json.loads(paths["traffic"].read_text())
    paths["loop"] = here / "loops" / f"{traffic['loop']}.py"
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    for m in per_layer:
        found = [p for p in (here / "metrics" / f"{q}.py" for q in quantities(m["name"])) if p.is_file()]
        paths[m["name"]] = found[0] if found else here / "metrics" / f"{m['name']}.py"
    for key, p in paths.items():
        if not p.is_file():
            raise FileNotFoundError(f"cell {name}: no file {p} for {key}")
    return Cell(workload=w, config=json.loads(paths["config"].read_text()), traffic=traffic,
                limits=json.loads(paths["limits"].read_text()), end_to_end=e2e,
                per_layer=per_layer, paths=paths)


def quantities(name: str) -> list:
    """``name`` and the names it falls back to, longest first:
    ``a.b.c`` -> [``a.b.c``, ``a.b``, ``a``]."""
    parts = name.split(".")
    return [".".join(parts[:k]) for k in range(len(parts), 0, -1)]


def value_of(name: str, reported: dict):
    """The value a loop reported for the end-to-end metric ``name``, under
    its own name or the first of those it falls back to."""
    for q in quantities(name):
        if q in reported:
            return reported[q]
    raise KeyError(f"the loop reports no {name!r} (have {sorted(reported)})")


def load_module(path: Path, name: str = None):
    """Import the file ``path`` as a module of its own (file names such as
    ``mfu_pct.train.py`` are not package names)."""
    spec = importlib.util.spec_from_file_location(name or f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
