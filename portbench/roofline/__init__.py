"""Operation and byte counts of the port's work, and the card's peaks.

The counts are the algorithm's, computed from shapes, the same whatever
implements the work; the peaks are the data sheet's (``peaks.json``).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str = "NVIDIA H100 80GB HBM3") -> dict:
    """The card's peaks: float32 operations (no tensor cores; TF32 stays
    off), float64 on the tensor cores, and HBM bandwidth, per second.
    Every H100 part takes the SXM data sheet's numbers: the benchmark runs
    on no other card."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(kind, table["NVIDIA H100 80GB HBM3"])


def least_s(nbytes: float, flops: float, kind: str = "NVIDIA H100 80GB HBM3") -> float:
    """The least time of a piece of work: the larger of its bytes at the
    HBM bandwidth and its operations at the float32 rate."""
    p = peaks(kind)
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["f32_flop_per_s"])
