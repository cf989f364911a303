"""Bytes and operations of one launch of each scan kernel, K1 to K4b.

Copied from chip_smoke.py (``_k1_flops`` .. ``_k4b_flops`` and the tensors
``check_kernels`` counts in ``_nbytes``), frozen here.  Bytes: each input
read once and each output written once, float32 (4 bytes); operations per
time step from csrc/ (d x d products 2 d^3, matrix-vector products 2 d^2).
n time steps of state dimension d in nb time blocks; B columns for K3,
C for K4a/K4b.
"""

from __future__ import annotations

F32 = 4

# The device kernels each launch runs, by the name torch.profiler gives
# them, and how many of each one launch runs (csrc/*.cu).
DEVICE_KERNELS = {
    "K1": (("phase1_kernel", 1),),
    "K2": (("phase3_kernel", 1),),
    "K3": (("sweep_kernel", 2), ("prefix_kernel", 1), ("ll_sum_kernel", 1)),
    "K4a": (("suffix_reduce_kernel", 1),),
    "K4b": (("suffix_replay_kernel", 1),),
}


def k1_flops(d):
    return 4 * d**3 + 4 * d * d + d * (d + 1) * (d + 2) + 3 + 6 * d


def k2_flops(d):
    return 2 * d * d + 2 * 2 * d**3 + d * d + 2 * d * d + 4 * d * d + 4 * d + 12


def k3_flops(d, B):
    return B * (2 * d + 3 + d * (2 * d + 2) + 5)


def k4a_flops(d, C):
    return 2 * d * d * C + 6 * d**3


def k4b_flops(d, C):
    return 2 * d * d * C + 4 * d**3


def k1(n, d, nb):
    """(bytes, operations): A, Q (n, d, d), R, y (n,) in; per block the
    element A, C, J (d, d) and b, eta (d,) out."""
    return F32 * ((2 * d * d + 2) * n + nb * (3 * d * d + 2 * d)), n * k1_flops(d)


def k2(n, d, nb):
    """A, Q, R, y and the block inits m0 (nb, d), P0 (nb, d, d) in; alpha,
    log S (n,), K, m (n, d), P (n, d, d) and two per-block sums out."""
    nbytes = (2 * d * d + 2) * n + nb * (d + d * d) + n * (2 + 2 * d + d * d) + 2 * nb
    return F32 * nbytes, n * k2_flops(d)


def k3(n, d, B, means):
    """Gain rows (n, 3 + 2d + d^2) and the columns (n, B) in; the whitened
    columns (n, B) and B log-likelihoods out, with the filtered means
    (n, d, B) too when ``means`` (training's forward)."""
    nbytes = n * (3 + 2 * d + d * d) + 2 * n * B + B + (n * d * B if means else 0)
    return F32 * nbytes, n * k3_flops(d, B)


def k4a(n, d, C, nb):
    """E, L (n, d, d) and g (n, d, C) in; per block E, L (d, d), g (d, C) out."""
    return F32 * (n * (2 * d * d + d * C) + nb * (2 * d * d + d * C)), n * k4a_flops(d, C)


def k4b(n, d, C, nb):
    """E, L, g and the block inits g0 (nb, d, C), L0 (nb, d, d) in; v
    (n, d, C) and M (n, d, d) out."""
    nbytes = n * (2 * d * d + d * C) + nb * (d * C + d * d) + n * (d * C + d * d)
    return F32 * nbytes, n * k4b_flops(d, C)


def num_blocks(n, blocks=16384, min_steps=16):
    """The scans' time blocking (ssm/blocked.py::num_blocks_for)."""
    return max(1, min(blocks, n // min_steps, n))
