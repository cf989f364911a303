"""Small dense Cholesky and triangular solves on the card: K6a, K6b, K6c.

Counterpart of ``gpar_at_scale_tpu/ops/pallas_dense.py``.  Three functions,
each with a CUDA kernel (``csrc/dense.cu``) and a plain PyTorch version that
repeats the kernel's recursion, right-looking panel by panel:

* ``chol_solve(S, B)`` -> ``(U, W, logdet, info)``: ``S = U^T U`` with U
  upper, ``W = U^-T B``, ``logdet S``, and ``info`` (0, or j + 1 for the
  first pivot j that is not positive, as ``torch.linalg.cholesky_ex``);
* ``tri_ut(U, B)`` -> ``U^-T B`` (forward substitution);
* ``tri_u(U, B)`` -> ``U^-1 B`` (backward substitution).

float32, ``n <= DENSE_N_MAX``; a leading batch axis is allowed (on the
kernels' grid).  Each is differentiable through a
``torch.autograd.Function`` whose backward is the JAX package's custom VJP,
built from the same kernels.  A wrapper runs its plain version for tensors on
the CPU, or when called with ``plain=True`` (the ``"interpret"`` mode of
``utils/psd.py``); for CUDA tensors it launches its kernel or raises.  The
wrappers return ``info`` and do not raise on it: ``utils/psd.py`` turns it
into the error ``torch.linalg.cholesky`` raises.
"""

from __future__ import annotations

import math

import torch

from gpar_at_scale_torch.ops.build import CudaKernel, ptr, require_f32

DENSE_N_MAX = 512  # the JAX package's PALLAS_DENSE_N_MAX
_NB = 16  # panel rows, as in csrc/dense.cu
_TINY = 1e-30  # the pivot and log clamps of the TPU kernel

_SRC = "gpar_at_scale_tpu/ops/pallas_dense.py"
K6A = CudaKernel("K6a chol_solve", "dense", "dense_chol_solve", f"{_SRC}:171")
K6B = CudaKernel("K6b tri_ut", "dense", "dense_tri_ut", f"{_SRC}:218")
K6C = CudaKernel("K6c tri_u", "dense", "dense_tri_u", f"{_SRC}:236")


def _check(name, A, B):
    n = A.shape[-1]
    if A.ndim < 2 or A.shape[-2] != n or B.ndim != A.ndim or B.shape[:-1] != A.shape[:-1]:
        raise ValueError(f"{name}: shapes {tuple(A.shape)} and {tuple(B.shape)} do not fit")
    if not 1 <= n <= DENSE_N_MAX:
        raise ValueError(f"{name}: n = {n} is outside 1..{DENSE_N_MAX}")
    A, B = A.contiguous(), B.contiguous()
    require_f32(name, A, B)
    return A, B


def _solve_panel(Ps, invd, r0, nbp, X, forward):
    """The kernels' step for one panel on X (..., n, k) in place: the pivots
    r0 .. r0 + nbp - 1, whose coefficient rows are Ps (..., nbp, n), solved
    right-looking (each solved pivot at once subtracted from the panel's
    later ones), then the update of every later equation by their sum."""
    Xp = X[..., r0:r0 + nbp, :].clone()
    for q in range(nbp) if forward else range(nbp - 1, -1, -1):
        Xp[..., q, :] *= invd[..., q, None]
        later = slice(q + 1, nbp) if forward else slice(0, q)
        coef = Ps[..., q, r0 + later.start:r0 + later.stop]  # (..., pivots after q)
        Xp[..., later, :] -= coef[..., :, None] * Xp[..., q, None, :]
    X[..., r0:r0 + nbp, :] = Xp
    later = slice(r0 + nbp, None) if forward else slice(0, r0)
    X[..., later, :] -= Ps[..., :, later].transpose(-1, -2) @ Xp


def chol_solve_plain(S, B):
    """K6a's plain version: (U, W, logdet, info) by the kernel's
    recursion."""
    n = S.shape[-1]
    A = torch.triu(S)  # the residual's upper triangle
    W = B.clone()
    U = torch.zeros_like(S)
    lead = S.shape[:-2]
    ld = torch.zeros(lead, dtype=torch.float64, device=S.device)
    info = torch.zeros(lead, dtype=torch.int32, device=S.device)
    for r0 in range(0, n, _NB):
        nbp = min(_NB, n - r0)
        P = A[..., r0:r0 + nbp, :].clone()
        Up = torch.zeros_like(P)
        invd = []
        for jj in range(nbp):
            j = r0 + jj
            pivot = P[..., jj, j]
            inv = torch.rsqrt(torch.clamp(pivot, min=_TINY))
            Up[..., jj, j:] = P[..., jj, j:] * inv[..., None]
            coef = P[..., jj, j + 1:r0 + nbp] * inv[..., None]  # rows jj + 1 .. of the panel
            P[..., jj + 1:, :] -= coef[..., :, None] * Up[..., jj, None, :]
            info = torch.where((~(pivot > 0)) & (info == 0), j + 1, info)
            ld = ld + torch.log(torch.clamp(pivot * inv, min=_TINY)).double()
            invd.append(inv)
        U[..., r0:r0 + nbp, :] = Up
        _solve_panel(Up, torch.stack(invd, -1), r0, nbp, W, forward=True)
        t0 = r0 + nbp
        if t0 < n:
            Ut = Up[..., :, t0:]
            A[..., t0:, t0:] -= torch.triu(Ut.transpose(-1, -2) @ Ut)
    return U, W, (2.0 * ld).to(S.dtype), info


def _panels(n, forward):
    """(first pivot, pivots) of each panel, in the kernels' order: from the
    first row forward, from the last row backward."""
    if forward:
        return [(r0, min(_NB, n - r0)) for r0 in range(0, n, _NB)]
    return [(max(0, e - _NB), e - max(0, e - _NB)) for e in range(n, 0, -_NB)]


def _tri_plain(U, B, forward):
    X = B.clone()
    for r0, nbp in _panels(U.shape[-1], forward):
        d = torch.diagonal(U[..., r0:r0 + nbp, r0:r0 + nbp], dim1=-2, dim2=-1)
        # coefficient rows: pivot q's row of U (forward) or its column (backward)
        Ps = U[..., r0:r0 + nbp, :] if forward else U[..., :, r0:r0 + nbp].transpose(-1, -2)
        _solve_panel(Ps, 1.0 / d, r0, nbp, X, forward)
    return X


def tri_ut_plain(U, B):
    """K6b's plain version: U^-T B, panel by panel from the first row."""
    return _tri_plain(U, B, forward=True)


def tri_u_plain(U, B):
    """K6c's plain version: U^-1 B, panel by panel from the last row."""
    return _tri_plain(U, B, forward=False)


def _chol_solve_fwd(S, B, plain):
    S, B = _check("chol_solve", S, B)
    if plain or not S.is_cuda:
        return chol_solve_plain(S, B)
    n, k = S.shape[-1], B.shape[-1]
    U, W = torch.empty_like(S), torch.empty_like(B)
    ld = torch.empty(S.shape[:-2], dtype=S.dtype, device=S.device)
    info = torch.empty(S.shape[:-2], dtype=torch.int32, device=S.device)
    K6A(ptr(S), ptr(B), n, k, math.prod(S.shape[:-2]), ptr(U), ptr(W), ptr(ld), ptr(info))
    return U, W, ld, info


def _tri_fwd(U, B, forward, plain):
    U, B = _check("tri_ut" if forward else "tri_u", U, B)
    if B.shape[-1] == 0:
        return B.clone()
    if plain or not U.is_cuda:
        return _tri_plain(U, B, forward)
    X = torch.empty_like(B)
    (K6B if forward else K6C)(ptr(U), ptr(B), U.shape[-1], B.shape[-1], math.prod(U.shape[:-2]), ptr(X))
    return X


def _mT(x):
    return x.transpose(-1, -2)


class CholSolve(torch.autograd.Function):
    """K6a with the JAX package's ``_chol_solve_bwd``: three K6c solves."""

    @staticmethod
    def forward(ctx, S, B, plain):
        U, W, ld, info = _chol_solve_fwd(S, B, plain)
        ctx.save_for_backward(U, W)
        ctx.plain = plain
        ctx.mark_non_differentiable(info)
        return U, W, ld, info

    @staticmethod
    def backward(ctx, U_bar, W_bar, ld_bar, _info_bar):
        U, W = ctx.saved_tensors
        # From W = U^-T B: B_bar = U^-1 W_bar, and U gets -triu(W B_bar^T).
        B_bar = _tri_fwd(U, W_bar, False, ctx.plain)
        Ub = U_bar - torch.triu(W @ _mT(B_bar))
        # From logdet = 2 sum log diag(U).
        Ub = Ub + torch.diag_embed(2.0 * ld_bar[..., None] / torch.diagonal(U, dim1=-2, dim2=-1))
        # Cholesky adjoint in U-form: M = U Ub^T, Phi = tril(M) - diag(M) / 2,
        # S_bar = U^-1 Phi U^-T, symmetrized.
        M = U @ _mT(Ub)
        Phi = torch.tril(M) - 0.5 * torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))
        X1 = _tri_fwd(U, Phi, False, ctx.plain)
        S_bar = _mT(_tri_fwd(U, _mT(X1), False, ctx.plain))
        return 0.5 * (S_bar + _mT(S_bar)), B_bar, None


class TriUT(torch.autograd.Function):
    """K6b with the JAX package's ``_tri_ut_bwd`` (one K6c solve)."""

    @staticmethod
    def forward(ctx, U, B, plain):
        X = _tri_fwd(U, B, True, plain)
        ctx.save_for_backward(U, X)
        ctx.plain = plain
        return X

    @staticmethod
    def backward(ctx, X_bar):
        U, X = ctx.saved_tensors
        B_bar = _tri_fwd(U, X_bar, False, ctx.plain)
        return -torch.triu(X @ _mT(B_bar)), B_bar, None


class TriU(torch.autograd.Function):
    """K6c with the JAX package's ``_tri_u_bwd`` (one K6b solve)."""

    @staticmethod
    def forward(ctx, U, B, plain):
        X = _tri_fwd(U, B, False, plain)
        ctx.save_for_backward(U, X)
        ctx.plain = plain
        return X

    @staticmethod
    def backward(ctx, X_bar):
        U, X = ctx.saved_tensors
        B_bar = _tri_fwd(U, X_bar, True, ctx.plain)
        return -torch.triu(B_bar @ _mT(X)), B_bar, None


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def chol_solve(S, B, plain: bool = False):
    """(U, W, logdet, info) of S (..., n, n) and B (..., n, k): K6a on CUDA
    tensors, its plain version on CPU tensors or with ``plain``."""
    if _needs_grad(S, B):
        return CholSolve.apply(S, B, plain)
    return _chol_solve_fwd(S, B, plain)


def tri_ut(U, B, plain: bool = False):
    """X = U^-T B for U upper (..., n, n): K6b."""
    return TriUT.apply(U, B, plain) if _needs_grad(U, B) else _tri_fwd(U, B, True, plain)


def tri_u(U, B, plain: bool = False):
    """X = U^-1 B for U upper (..., n, n): K6c."""
    return TriU.apply(U, B, plain) if _needs_grad(U, B) else _tri_fwd(U, B, False, plain)
