"""EEG multi-output dataset: CSV loader and synthetic generator.

A copy of ``gpar_at_scale_tpu/data/eeg.py`` in numpy (the port imports
nothing of the JAX package; CSVs go through ``data/native_io.py``): the
same channels, chain order and split, and the same numbers from the same
seed.  The real recordings of the EEG
example are not in the repository, so the synthetic generator is what runs:
7 channels (F3, F4, F5, F6, FZ, F1, F2) x 256 points at 256 Hz, later
channels driven by earlier ones.  F3-F6 are observed for all 256 points;
FZ, F1, F2 for the first 156 (``TRAIN_POINTS``) and predicted for the rest.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np

from gpar_at_scale_torch.data.native_io import read_csv

CHANNELS = ("F3", "F4", "F5", "F6", "FZ", "F1", "F2")
# chain: fully-observed channels first, then the predicted ones
CHAIN_ORDER = ("F3", "F4", "F5", "F6", "FZ", "F1", "F2")
NUM_POINTS = 256
TRAIN_POINTS = 156


class EEGDataset(NamedTuple):
    t: np.ndarray  # (256,) time in seconds
    Y: np.ndarray  # (256, 7) channels in CHAIN_ORDER
    channels: Sequence[str]

    @property
    def t_train(self):
        return self.t[:TRAIN_POINTS]

    @property
    def t_test(self):
        return self.t[TRAIN_POINTS:]

    @property
    def Y_train(self):
        return self.Y[:TRAIN_POINTS]

    @property
    def Y_test(self):
        return self.Y[TRAIN_POINTS:]


def load_eeg_csv(path: str) -> EEGDataset:
    """Load an EEG CSV whose header row names the channels (comma
    separated, one row per time point at 256 Hz), through ``read_csv``: a
    text or empty cell reads as NaN, as in the JAX package."""
    data, header = read_csv(path)
    cols = {name: header.index(name) for name in CHAIN_ORDER}
    Y = np.stack([data[:, cols[c]] for c in CHAIN_ORDER], axis=1)
    t = np.arange(1, Y.shape[0] + 1) / 256.0
    return EEGDataset(t=t, Y=Y, channels=CHAIN_ORDER)


def generate_synthetic_eeg(seed: int = 0) -> EEGDataset:
    """7-channel synthetic EEG with alpha-band-like oscillations, slow
    drift, and chained cross-channel structure (FZ/F1/F2 depend on the
    frontal channels), 256 points at 256 Hz."""
    rng = np.random.default_rng(seed)
    n = NUM_POINTS
    t = np.arange(1, n + 1) / 256.0

    def band(f_lo, f_hi, amp):
        f = rng.uniform(f_lo, f_hi)
        phase = rng.uniform(0, 2 * np.pi)
        return amp * np.sin(2 * np.pi * f * t + phase)

    def drift(amp):
        return amp * np.cumsum(rng.normal(size=n)) / np.sqrt(n)

    obs_noise = 0.3

    F3 = band(8, 12, 2.0) + band(4, 7, 1.0) + drift(1.0)
    F4 = band(8, 12, 2.0) + band(13, 20, 0.7) + drift(1.0)
    F5 = 0.6 * F3 + band(8, 12, 1.2) + drift(0.8)
    F6 = 0.6 * F4 + band(4, 7, 1.0) + drift(0.8)
    FZ = 0.4 * (F3 + F4) + 0.2 * np.tanh(F5) + band(8, 12, 0.8)
    F1 = 0.5 * FZ + 0.3 * F3 + band(4, 7, 0.6)
    F2 = 0.5 * FZ + 0.3 * F4 + 0.2 * F1 + band(8, 12, 0.5)

    Y = np.stack([F3, F4, F5, F6, FZ, F1, F2], axis=1)
    Y = Y + obs_noise * rng.normal(size=Y.shape)
    return EEGDataset(t=t, Y=Y, channels=CHAIN_ORDER)


def load_eeg(path: str | None = None, seed: int = 0) -> EEGDataset:
    """Real CSV if present, synthetic otherwise."""
    if path and os.path.exists(path):
        return load_eeg_csv(path)
    return generate_synthetic_eeg(seed)
