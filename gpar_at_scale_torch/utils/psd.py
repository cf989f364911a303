"""Positive-semi-definite linear-algebra helpers.

Counterpart of ``gpar_at_scale_tpu/utils/psd.py``.  Dense factorizations
and triangular solves go through ``torch.linalg``, or, switched on by
``engine.pallas_dense`` (``config.py``) for 2-D float32 matrices with
8 <= n <= 512, through the hand-written kernels K6a/K6b/K6c of
``ops/dense.py``, keeping call sites and autograd unchanged:

* ``"off"`` (default): ``torch.linalg`` everywhere;
* ``"on"``: the CUDA kernels for CUDA tensors, ``torch.linalg`` for
  anything else (the JAX package sends everything off a TPU to XLA);
* ``"interpret"``: the kernels' plain versions on any device (the CPU test
  hook, the counterpart of Pallas interpret mode).

A factorization that fails raises ``torch.linalg.LinAlgError``, on either
path, instead of returning NaNs; the ``_ex`` variants return the info word
instead (0, or j + 1 for the first pivot j that is not positive, as
``torch.linalg.cholesky_ex``), so that a batch of factorizations can mark
the ones that failed.  The factorizations and solves take leading batch
axes; the kernels take them on their grid.
"""

from __future__ import annotations

import os

import torch

from gpar_at_scale_torch.utils.observability import host_sync

_MODES = ("off", "on", "interpret")
_DENSE_N_MIN = 8


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


def pallas_dense_mode() -> str:
    """The dense dispatch mode, "off" | "on" | "interpret": the runtime
    config's ``engine.pallas_dense``, overridden by the environment with
    the JAX package's precedence (``GPAR_NO_PALLAS_DENSE`` >
    ``GPAR_PALLAS_DENSE_INTERPRET`` > ``GPAR_PALLAS_DENSE``)."""
    if os.environ.get("GPAR_NO_PALLAS_DENSE"):
        return "off"
    if os.environ.get("GPAR_PALLAS_DENSE_INTERPRET"):
        return "interpret"
    if os.environ.get("GPAR_PALLAS_DENSE"):
        return "on"
    from gpar_at_scale_torch.config import get_config

    mode = get_config().engine.pallas_dense
    if mode not in _MODES:
        raise ValueError(f"engine.pallas_dense must be off|on|interpret, got {mode!r}")
    return mode


def _pallas_dense_ok(*tensors) -> bool:
    """True when K6a-c (or, under "interpret", their plain versions) take
    this call: the switch is not off, every tensor is float32 (and on the
    card under "on") and (..., n, k) with the first's leading batch axes,
    which the kernels take on their grid, and the first is n x n with
    8 <= n <= 512."""
    mode = pallas_dense_mode()
    if mode == "off" or (mode == "on" and not all(x.is_cuda for x in tensors)):
        return False
    from gpar_at_scale_torch.ops.dense import DENSE_N_MAX

    lead = tensors[0].shape[:-2]
    if any(x.ndim < 2 or x.shape[:-2] != lead or x.dtype != torch.float32 for x in tensors):
        return False
    return _DENSE_N_MIN <= tensors[0].shape[-1] <= DENSE_N_MAX


def _raise_on_info(info):
    """The error ``torch.linalg.cholesky`` raises, from K6a's info word."""
    bad = 0
    if info.numel():
        bad = int(info.max())
        host_sync()
    if bad:
        raise torch.linalg.LinAlgError(
            "linalg.cholesky: The factorization could not be completed because the input is "
            f"not positive-definite (the leading minor of order {bad} is not positive-definite)."
        )


def chol_solve_ex(S, B):
    """(U, W, logdet, info) with S = U^T U, W = U^-T B through K6a, for a
    call that ``_pallas_dense_ok(S, B)`` admits; does not raise."""
    from gpar_at_scale_torch.ops import dense

    return dense.chol_solve(S, B, plain=pallas_dense_mode() == "interpret")


def chol_solve(S, B):
    """``chol_solve_ex`` without the info word; raises if S is not positive
    definite."""
    U, W, logdet, info = chol_solve_ex(S, B)
    _raise_on_info(info)
    return U, W, logdet


def cholesky_psd_ex(K, jitter=None):
    """(L, info): the lower Cholesky factor of K with relative jitter and
    the factorization's info word; does not raise."""
    Kj = add_jitter(K, jitter)
    if _pallas_dense_ok(Kj):
        U, _, _, info = chol_solve_ex(Kj, Kj.new_zeros(Kj.shape[:-1] + (0,)))
        return U.transpose(-1, -2), info
    return torch.linalg.cholesky_ex(Kj)


def cholesky_psd(K, jitter=None):
    """Lower Cholesky factor of a PSD matrix with relative jitter; raises if
    the factorization fails."""
    L, info = cholesky_psd_ex(K, jitter)
    _raise_on_info(info)
    return L


def _solve(L, b, upper_of_L: bool):
    vec = b.ndim == L.ndim - 1
    b2 = b[..., None] if vec else b
    if b2.ndim == L.ndim and _pallas_dense_ok(L, b2):
        from gpar_at_scale_torch.ops import dense

        # The kernels take U = L^T: L^-1 b = U^-T b, L^-T b = U^-1 b.
        plain = pallas_dense_mode() == "interpret"
        x = (dense.tri_u if upper_of_L else dense.tri_ut)(L.transpose(-1, -2), b2, plain)
    elif upper_of_L:
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), b2, upper=True)
    else:
        x = torch.linalg.solve_triangular(L, b2, upper=False)
    return x[..., 0] if vec else x


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
