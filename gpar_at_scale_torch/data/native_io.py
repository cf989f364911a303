"""CSV ingest: ``read_csv`` and ``native_available``.

Counterpart of ``gpar_at_scale_tpu/data/native_io.py``, held to its Python
reader (``_read_csv_python``): non-numeric and empty cells become NaN, short
rows are padded with NaN, long rows are cut to the header's width, blank
lines are skipped and quoted header names are stripped.  The JAX package's
native parser (``native/csv_loader.cpp``) reads a text cell such as
``0:00`` as 0 and shifts the rest of the row, so the port does not wrap it.
"""

from __future__ import annotations

import csv
from typing import List, Tuple

import numpy as np


def native_available() -> bool:
    """Whether a native CSV parser backs ``read_csv``: never in the port,
    which reads with Python's ``csv`` module (the native parser shifts a
    row after a text cell; see the module docstring)."""
    return False


def _cell(text: str) -> float:
    try:
        return float(text)
    except ValueError:
        return float("nan")


def read_csv(path: str) -> Tuple[np.ndarray, List[str]]:
    """Parse a numeric CSV with a header row -> (data (R, C) float64, names)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        names = [h.strip().strip('"') for h in next(reader)]
        width = len(names)
        rows = []
        for row in reader:
            if not row:
                continue
            vals = [_cell(cell) for cell in row[:width]]
            rows.append(vals + [float("nan")] * (width - len(vals)))
    return np.asarray(rows, dtype=np.float64).reshape(len(rows), width), names
