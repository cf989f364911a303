"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: the kernels compile at their first
launch (``ops/build.py``).
"""

from gpar_at_scale_torch.ops.dense import K6A, K6B, K6C, chol_solve, tri_u, tri_ut
from gpar_at_scale_torch.ops.grad import (
    K5A,
    K5B,
    LgssmLoglik,
    MixedWhitenGram,
    WhitenGram,
    logpdf_markov_pallas,
)
from gpar_at_scale_torch.ops.kalman import K1, K2, decorrelate_blocked, pallas_supported
from gpar_at_scale_torch.ops.smoother import K4A, K4B, K7, pallas_smooth, suffix_scan
from gpar_at_scale_torch.ops.whiten import K3, whiten_columns, whiten_gram

KERNELS = (K1, K2, K3, K4A, K4B, K5A, K5B, K6A, K6B, K6C, K7)


def launch_counts():
    """{kernel name: its launches in this process so far}."""
    return {k.name: k.launches for k in KERNELS}


__all__ = [
    "K1", "K2", "K3", "K4A", "K4B", "K5A", "K5B", "K6A", "K6B", "K6C", "K7", "KERNELS", "launch_counts",
    "LgssmLoglik", "MixedWhitenGram", "WhitenGram", "chol_solve", "decorrelate_blocked", "logpdf_markov_pallas",
    "pallas_smooth", "pallas_supported", "suffix_scan", "tri_u", "tri_ut", "whiten_columns",
    "whiten_gram",
]
