"""A copy of the benchmark with its series cut to a size a CPU test holds."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_N = 3000


def tiny_copy(dest: Path, n: int = TINY_N) -> Path:
    """BENCHMARK.json and portbench/ under ``dest``, every training mix cut
    to ``n`` time steps; returns ``dest``."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest)
    for p in (dest / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        if "n" in mix:
            mix["n"] = n
            p.write_text(json.dumps(mix))
    return dest
