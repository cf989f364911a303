"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Importing this package builds nothing: the kernels compile at their first
launch (``ops/build.py``).
"""

from gpar_at_scale_torch.ops.kalman import K1, K2, decorrelate_blocked, pallas_supported
from gpar_at_scale_torch.ops.whiten import K3, whiten_columns, whiten_gram

KERNELS = (K1, K2, K3)

__all__ = [
    "K1", "K2", "K3", "KERNELS",
    "decorrelate_blocked", "pallas_supported", "whiten_columns", "whiten_gram",
]
