"""The synthetic chained conditional of the long-series benchmark.

Copied from gpar_at_scale_torch/benchmarks/million_dtc.py::make_data (the
JAX package's benchmarks/million_dtc.py:48-69) and frozen here.  The same
distribution, drawn on the device from a torch.Generator instead of numpy:
times uniform on [0, n / 1000), sorted; the inputs are two functions of
time standing for the previous outputs; y = f_t(t) + f_x(X) + 0.25 noise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F64 = torch.float64
NOISE_SIGMA = 0.25


class Data(NamedTuple):
    t: torch.Tensor  # (n,) sorted
    X: torch.Tensor  # (n, 2)
    y: torch.Tensor  # (n,)


def xcols(tv):
    return torch.stack([torch.sin(0.7 * tv) + 0.1 * torch.cos(3.1 * tv), torch.cos(0.23 * tv)], 1)


def f_t(tv):
    return 0.8 * torch.sin(2.2 * tv) * torch.cos(0.31 * tv)


def f_x(Xv):
    return 0.6 * torch.sin(1.3 * Xv[:, 0]) + 0.4 * Xv[:, 1]


def make(n: int, gen: torch.Generator, dtype=torch.float32) -> Data:
    """n training points on gen's device, float64 draws cast to ``dtype``
    (the program's working precision, times included)."""
    dev = gen.device
    t = torch.sort(torch.rand(n, generator=gen, dtype=F64, device=dev) * (n / 1000.0)).values
    X = xcols(t)
    y = f_t(t) + f_x(X) + NOISE_SIGMA * torch.randn(n, generator=gen, dtype=F64, device=dev)
    return Data(t.to(dtype), X.to(dtype), y.to(dtype))
