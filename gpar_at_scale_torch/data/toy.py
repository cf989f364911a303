"""Synthetic chained multi-output datasets.

A copy of ``gpar_at_scale_tpu/data/toy.py`` in numpy (the port imports
nothing of the JAX package): the same arrays from the same seed.  It mirrors
the reference's ``src/data/toy_data.jl``: 3 outputs where y2 depends on y1 and y3 on
(y1, y2); a "small" 30-point set and a "big" 10k-point set with 5 nuked gaps
of 300 points each.

Noise semantics: the reference passes ``observation_noise**2`` where Julia's
``Normal`` expects a *standard deviation* (defect K3, ``src/data/toy_data.jl:29``),
so its "noise 0.05" data actually has std 0.0025.  We default to the *correct*
semantics (std = observation_noise) and expose ``replicate_reference_noise_bug``
to reproduce the reference's generated data exactly when matching moments.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class ToyDataset(NamedTuple):
    x: np.ndarray  # (N,) observed time locations (after gap removal)
    y_obs: np.ndarray  # (N, 3) noisy outputs
    x_true: np.ndarray  # (T,) dense grid for the true functions
    y_true: np.ndarray  # (T, 3) noiseless outputs on the dense grid


START = 0.0
STEP_SIZE = 1.0 / 30.0
NOISE_MU = 0.0


def _nuke(x: np.ndarray, nr_intervals: int, per_interval: int):
    """Remove ``nr_intervals`` gaps of ``per_interval`` points
    (``src/data/toy_data.jl:42-57``)."""
    if nr_intervals == 0:
        return x, 0
    kept = len(x) // (nr_intervals + 1)
    pieces = [x[:kept]]
    for i in range(1, nr_intervals + 1):
        pieces.append(x[i * kept + per_interval : (i + 1) * kept])
    nuked = np.concatenate(pieces)
    return nuked, len(x) - len(nuked)


def _generate(
    data_samples: int,
    true_samples: int,
    f1: Callable,
    f2: Callable,
    f3: Callable,
    *,
    observation_noise: float,
    extended_true_period: float = 0.0,
    nr_nuked_intervals: int = 0,
    nuked_per_interval: int = 0,
    replicate_reference_noise_bug: bool = False,
    seed: int = 0,
) -> ToyDataset:
    rng = np.random.default_rng(seed)
    stop = STEP_SIZE * data_samples
    x_true = np.linspace(START, stop + extended_true_period, true_samples)
    y1_t = f1(x_true)
    y2_t = f2(x_true, y1_t)
    y3_t = f3(x_true, y1_t, y2_t)
    y_true = np.stack([y1_t, y2_t, y3_t], axis=1)

    sigma = observation_noise**2 if replicate_reference_noise_bug else observation_noise
    x = np.linspace(START, stop, data_samples)
    x, _removed = _nuke(x, nr_nuked_intervals, nuked_per_interval)
    n = len(x)
    y1 = f1(x) + rng.normal(NOISE_MU, sigma, n)
    y2 = f2(x, y1) + rng.normal(NOISE_MU, sigma, n)
    y3 = f3(x, y1, y2) + rng.normal(NOISE_MU, sigma, n)
    return ToyDataset(x=x, y_obs=np.stack([y1, y2, y3], axis=1), x_true=x_true, y_true=y_true)


# --- small dataset (src/data/toy_data.jl:59-74) ---------------------------

_f1_small = lambda x: -np.sin(10 * np.pi * (x + 1)) / (2 * x + 1) - x**4
_f2_small = lambda x, y1: np.cos(y1) ** 2 + np.sin(3 * x)
_f3_small = lambda x, y1, y2: y2 * (y1**2) + 3 * x


def generate_small_dataset(seed: int = 0, **kwargs) -> ToyDataset:
    """30 points, noise 0.05 (``src/data/toy_data.jl:59-74``)."""
    return _generate(
        30, 1000, _f1_small, _f2_small, _f3_small, observation_noise=0.05, seed=seed, **kwargs
    )


# --- big dataset (src/data/toy_data.jl:76-98) -----------------------------

_f1_big = lambda x: 3.0 + -np.sin(np.pi / 10 * (x + 1)) - x**0.3
_f2_big = lambda x, y1: np.cos(y1) ** 2 + np.sin(np.pi / 20 * x)
_f3_big = lambda x, y1, y2: y2 * (y1**2) + 0.1 * x


def generate_big_dataset(seed: int = 0, **kwargs) -> ToyDataset:
    """10k points with 5 nuked 300-point gaps, noise 0.8, true curve extended
    50 units past the data (``src/data/toy_data.jl:76-98``)."""
    return _generate(
        10_000,
        100_000,
        _f1_big,
        _f2_big,
        _f3_big,
        observation_noise=0.8,
        extended_true_period=50.0,
        nr_nuked_intervals=5,
        nuked_per_interval=300,
        seed=seed,
        **kwargs,
    )
