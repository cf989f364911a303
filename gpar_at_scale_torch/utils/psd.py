"""Positive-semi-definite linear-algebra helpers.

Counterpart of ``gpar_at_scale_tpu/utils/psd.py`` without its opt-in fused
dense-kernel dispatch (``ops/pallas_dense.py``, still to be ported).  A
factorization that fails raises (``torch.linalg.cholesky``) instead of
returning NaNs.
"""

from __future__ import annotations

import torch


def default_jitter(dtype) -> float:
    """Relative jitter scaled for the working precision."""
    return 1e-10 if dtype == torch.float64 else 1e-6


def add_jitter(K, jitter=None):
    """K + jitter * mean(diag(K)) * I: relative jitter keeps conditioning
    scale-free across kernel variances."""
    if jitter is None:
        jitter = default_jitter(K.dtype)
    n = K.shape[-1]
    scale = torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    return K + (jitter * scale)[..., None, None] * eye


def cholesky_psd(K, jitter=None):
    """Lower Cholesky factor of a PSD matrix with relative jitter."""
    return torch.linalg.cholesky(add_jitter(K, jitter))


def _solve(L, b, upper_of_L: bool):
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    if upper_of_L:
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), b2, upper=True)
    else:
        x = torch.linalg.solve_triangular(L, b2, upper=False)
    return x[:, 0] if vec else x


def solve_lower(L, b):
    """Solve L x = b with L lower triangular."""
    return _solve(L, b, upper_of_L=False)


def solve_upper(L, b):
    """Solve L^T x = b with L lower triangular."""
    return _solve(L, b, upper_of_L=True)


def cho_solve(L, b):
    """Solve (L L^T) x = b."""
    return solve_upper(L, solve_lower(L, b))


def logdet_from_chol(L):
    """log det(L L^T) = 2 * sum(log diag L)."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
