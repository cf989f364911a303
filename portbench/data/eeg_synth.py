"""Seeded synthetic data at the shapes of the EEG experiment.

Copied from gpar_at_scale_torch/benchmarks/bench.py::bench_data (the repo's
bench.py:52-66) and frozen here, widened from 3 to D conditioning columns
and drawn on the device from a torch.Generator instead of numpy seed 0:
t = 1..n over 64 Hz, test times the n* samples after them, standard normal
inputs X, y = sin(3 t) + 0.2 X[:, 0] + 0.05 noise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F64 = torch.float64


class Data(NamedTuple):
    t: torch.Tensor  # (n,)
    t_star: torch.Tensor  # (n*,)
    X: torch.Tensor  # (n, D)
    X_star: torch.Tensor  # (n*, D)
    y: torch.Tensor  # (n,)


def make(n: int, n_star: int, D: int, gen: torch.Generator, dtype=torch.float32) -> Data:
    dev = gen.device
    t = torch.arange(1, n + 1, dtype=F64, device=dev) / 64.0
    t_star = (n + torch.arange(1, n_star + 1, dtype=F64, device=dev)) / 64.0
    X = torch.randn(n, D, generator=gen, dtype=F64, device=dev)
    X_star = torch.randn(n_star, D, generator=gen, dtype=F64, device=dev)
    y = torch.sin(3 * t) + 0.2 * X[:, 0] + 0.05 * torch.randn(n, generator=gen, dtype=F64, device=dev)
    return Data(*(a.to(dtype) for a in (t, t_star, X, X_star, y)))
