"""Closed-form gradients through the blocked Kalman filter (tensor code).

Counterpart of ``gpar_at_scale_tpu/ssm/blocked_grad.py``: the gradient of
the filter's log-likelihood, and of the whitened Gram G = U^T Sigma^-1 U
with log det Sigma, by the De Jong / Koopman disturbance smoother instead
of autograd through the scans.  With the filter's innovations e_k, their
variances S_k, gains K_k and filtered moments (m_k, P_k), the adjoint
recursions (r_n = 0, N_n = 0)

    C_k = (A_{k+1} (I - K_k H))^T
    r_k = H^T e_k / S_k + C_k r_{k+1}        (one column per column of U)
    N_k = H^T H / S_k   + C_k N_{k+1} C_k^T  (shared by the columns)

are one suffix scan of the smoothing algebra, and with
ctsym = sym(ct_G), u = Sigma^-1 U and D_k = 1/S_k + (A_{k+1} K_k)^T
N_{k+1} (A_{k+1} K_k) the exact cotangents are

    ct_Q_k = -r_k ctsym r_k^T + ct_ld N_k
    ct_A_k = -2 (r_k ctsym r_k^T A_k P_{k-1} + r_k ctsym m_{k-1}^T)
             + 2 ct_ld N_k A_k P_{k-1}
    ct_R_k = -u_k ctsym u_k^T + ct_ld D_k
    ct_U   = 2 u ctsym.

Nothing inverts Q or Pp; the only divisions are by S_k.  The log-likelihood
of one series is ll = -(y^T Sigma^-1 y + log det Sigma + N log 2 pi) / 2,
so its cotangents are the Gram's at ct_G = ct_ld = -1/2 (``loglik_bwd``).

This is the ``filter_impl="blocked"`` engine: forward ``blocked_filter``,
backward ``blocked_suffix_scan``, both tensor code, for any state dim and
emission row H (sum kernels too).  ``whiten_bwd_elements`` and
``whiten_bwd_scores`` are shared with the kernel path (``ops/grad.py``),
whose scan runs on K4a/K4b, and with the segmented gradient
(``ssm/segmented.py``), whose segments carry the rows before and after
them (``before``, ``after``).  H is structural and gets no cotangent.

The mixed-column backward (``cotangent_factor``, ``whiten_bwd_mixed_chunk``,
``whiten_bwd_ld_part``) bounds the backward's memory at any M.  The DTC
bound's Gram cotangent is negative definite, ctsym = -F F^T, and every
backward quantity is linear in the columns, so the backward of the M + 1
columns U is the sum over chunks of mixed columns U F_k, each a backward of
K columns with ct_G = -I; the ct_ld terms (the shared information matrix N)
come from one extra column.  No (N, d, M + 1) array is made.
"""

from __future__ import annotations

import numpy as np
import torch

from gpar_at_scale_torch.ssm.blocked import blocked_filter, blocked_suffix_scan
from gpar_at_scale_torch.ssm.markov import LGSSM


def _row(x, value):
    """``value`` as one row of x (zeros if None)."""
    if value is None:
        return torch.zeros_like(x[:1])
    return torch.as_tensor(value, dtype=x.dtype, device=x.device).reshape(x[:1].shape)


def _shift_down(x, first=None):
    """x_{k-1}, with x_{-1} = ``first`` (zeros if None): rows shifted one
    step later."""
    return torch.cat([_row(x, first), x[:-1]])


def _shift_up(x, last=None):
    """x_{k+1}, with x_n = ``last`` (zeros if None): rows shifted one step
    earlier."""
    return torch.cat([x[1:], _row(x, last)])


def _filter_aux(lgssm: LGSSM, Y):
    res = blocked_filter(lgssm, Y)
    K = torch.einsum("nij,j->ni", res.Pp, lgssm.H) / res.S[:, None]
    return res, (res.v, res.S, K, res.m, res.P)


def whiten_bwd_elements(A, H, aux, A_after=None):
    """The (C (n, d, d), b (n, d, B), W (n, d, d)) suffix-scan elements of
    the adjoint recursions; only b carries the columns.  ``A_after``: the
    transition of the step after the series (a later segment's first
    step), which the last step's C crosses to; zero if None."""
    e, S, K, _, _ = aux
    d = K.shape[1]
    I = torch.eye(d, dtype=A.dtype, device=A.device)
    ImKH = I - K[:, :, None] * H[None, None, :]
    C = (_shift_up(A, A_after) @ ImKH).transpose(-1, -2)  # (A_{k+1} (I - K_k H))^T
    b = H[None, :, None] * (e / S[:, None])[:, None, :]
    W = (1.0 / S)[:, None, None] * torch.outer(H, H)
    return C.contiguous(), b.contiguous(), W.contiguous()


def whiten_bwd_scores(A, H, aux, r, Nmat, ct_G, ct_ld, before=None, after=None):
    """(ct_A, ct_Q, ct_R, ct_U) from the scanned adjoints r (n, d, B) and
    N (n, d, d).  ``ct_G`` and ``ct_ld`` arrive in any float type and are
    cast to A's (float32 on the kernel path).

    A segment of a longer series (``ssm/segmented.py``) takes its carries:
    ``before`` = (m (d, B), P (d, d)), the filtered state of the step before
    it, and ``after`` = (A (d, d), r (d, B), N (d, d)), the transition and
    adjoints of the step after it; zeros if None."""
    e, S, K, m, P = aux
    dtype = A.dtype
    ct_G = torch.as_tensor(ct_G, device=A.device).to(dtype)
    ctsym = 0.5 * (ct_G + ct_G.T)
    ct_ld = torch.as_tensor(ct_ld, device=A.device).to(dtype)
    m_b, P_b = (None, None) if before is None else before
    A_a, r_a, N_a = (None, None, None) if after is None else after

    AP = A @ _shift_down(P, P_b)  # A_k P_{k-1}
    AK = torch.einsum("nij,nj->ni", _shift_up(A, A_a), K)  # A_{k+1} K_k
    u = e / S[:, None] - torch.einsum("nd,ndb->nb", AK, _shift_up(r, r_a))  # Sigma^-1 U
    D = 1.0 / S + torch.einsum("nd,nde,ne->n", AK, _shift_up(Nmat, N_a), AK)

    rc = torch.einsum("nib,bc->nic", r, ctsym)
    R2 = rc @ r.transpose(-1, -2)  # r ctsym r^T
    Rm = rc @ _shift_down(m, m_b).transpose(-1, -2)  # r ctsym m_{k-1}^T
    ct_A = -2.0 * (R2 @ AP + Rm) + (2.0 * ct_ld) * (Nmat @ AP)
    ct_Q = -R2 + ct_ld * Nmat
    ct_R = -((u @ ctsym) * u).sum(1) + ct_ld * D
    ct_U = 2.0 * (u @ ctsym)
    return ct_A, ct_Q, ct_R, ct_U


def whiten_fwd_aux(A, Q, R, H, U):
    """Forward half: one batched blocked filter over the columns U (N, B).
    Returns (G, logdet, aux), G = U^T Sigma^-1 U formed in float64 from the
    whitened columns, aux = (e, S, K, m, P) for the backward half."""
    res, aux = _filter_aux(LGSSM(A=A, Q=Q, H=H, R=R), U)
    W = (res.v / torch.sqrt(res.S)[:, None]).double()
    return W.T @ W, torch.log(res.S).double().sum(), aux


def whiten_bwd(A, H, aux, ct_G, ct_ld):
    """Backward half: (ct_A, ct_Q, ct_R, ct_U) through one blocked suffix
    scan of the adjoint elements."""
    C, b, W = whiten_bwd_elements(A, H, aux)
    _, r, Nmat = blocked_suffix_scan(C, b, W)
    return whiten_bwd_scores(A, H, aux, r, Nmat, ct_G, ct_ld)


def cotangent_factor(ct_G):
    """F (B, B), float64 numpy, with sym(ct_G) = -F F^T: the Cholesky factor
    of the negated symmetric cotangent, with a relative ridge of 1e-12 of its
    mean diagonal for semidefinite edge cases.  The DTC bound's Gram
    cotangent is negative definite (-ctsym = [[1, -beta^T], [-beta,
    P^-1 + beta beta^T]] / 2, whose Schur complement P^-1 / 2 + beta
    beta^T / 4 > 0).  On the host, as in the JAX package: (M + 1)^2 numbers."""
    ct = np.asarray(torch.as_tensor(ct_G).detach().cpu(), dtype=np.float64)
    neg = -0.5 * (ct + ct.T)
    b = neg.shape[0]
    ridge = 1e-12 * max(float(np.trace(neg)) / b, 1e-300)
    return np.linalg.cholesky(neg + ridge * np.eye(b))


def whiten_bwd_mixed_chunk(A, Q, R, H, U, Fk, ct_chunk=None):
    """The partial cotangents (ct_A, ct_Q, ct_R, ct_U) of one chunk of mixed
    columns U F_k, F_k (B, K) columns of ``cotangent_factor``'s F: one
    K-column filter and adjoint scan (W = 0: only r is needed), scored at
    ct_G = ``ct_chunk`` (K, K) (-I if None, the DTC bound's), ct_ld = 0.  Summed over the chunks of F and with
    ``whiten_bwd_ld_part``, they are ``whiten_bwd``'s cotangents; every array
    is K columns wide but ct_U (N, B)."""
    Fk = torch.as_tensor(Fk, device=A.device).to(A.dtype)
    _, aux = _filter_aux(LGSSM(A=A, Q=Q, H=H, R=R), U @ Fk)
    C, b, W = whiten_bwd_elements(A, H, aux)
    _, r, Nmat = blocked_suffix_scan(C, b, torch.zeros_like(W))
    if ct_chunk is None:
        ct_chunk = -torch.eye(Fk.shape[1], dtype=A.dtype, device=A.device)
    ct_A, ct_Q, ct_R, ct_Ut = whiten_bwd_scores(A, H, aux, r, Nmat, ct_chunk, 0.0)
    return ct_A, ct_Q, ct_R, ct_Ut @ Fk.T


def whiten_bwd_ld_part(A, Q, R, H, ct_ld):
    """The ct_ld terms of ``whiten_bwd`` (the information matrix N shared by
    the columns): one column y = 0 with W, scored at ct_G = 0.  Returns
    (ct_A, ct_Q, ct_R)."""
    _, aux = _filter_aux(LGSSM(A=A, Q=Q, H=H, R=R), A.new_zeros((A.shape[0], 1)))
    ct_A, ct_Q, ct_R, _ = whiten_bwd(A, H, aux, A.new_zeros((1, 1)), ct_ld)
    return ct_A, ct_Q, ct_R


def loglik_fwd_aux(A, Q, R, H, y):
    """Forward half for one series y (N,): (ll, aux), aux as in
    ``whiten_fwd_aux`` with one column."""
    res, aux = _filter_aux(LGSSM(A=A, Q=Q, H=H, R=R), y[:, None])
    return res.ll[0], aux


def loglik_bwd(A, H, aux):
    """Backward half for one series: (dA, dQ, dR, dy) of ll, the Gram's
    cotangents at ct_G = ct_ld = -1/2."""
    half = torch.full((1, 1), -0.5, dtype=A.dtype, device=A.device)
    dA, dQ, dR, dU = whiten_bwd(A, H, aux, half, -0.5)
    return dA, dQ, dR, dU[:, 0]


class _BlockedLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, Q, R, H, y):
        ll, aux = loglik_fwd_aux(A, Q, R, H, y)
        ctx.save_for_backward(A, H, *aux)
        return ll

    @staticmethod
    def backward(ctx, ct):
        A, H, *aux = ctx.saved_tensors
        dA, dQ, dR, dy = loglik_bwd(A, H, tuple(aux))
        return ct * dA, ct * dQ, ct * dR, None, ct * dy


def blocked_loglik(lgssm: LGSSM, y):
    """Log-likelihood of one series through the blocked filter, with the
    closed-form disturbance-smoother gradient in (A, Q, R, y)."""
    n = lgssm.num_steps
    dtype = lgssm.A.dtype
    R = lgssm.R.to(dtype).expand(n)
    y = torch.as_tensor(y, device=lgssm.A.device).to(dtype)
    return _BlockedLoglik.apply(lgssm.A, lgssm.Q, R, lgssm.H.to(dtype), y)


class _WhitenGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, Q, R, H, U):
        G, logdet, aux = whiten_fwd_aux(A, Q, R, H, U)
        ctx.save_for_backward(A, H, *aux)
        return G, logdet

    @staticmethod
    def backward(ctx, ct_G, ct_ld):
        A, H, *aux = ctx.saved_tensors
        ct_A, ct_Q, ct_R, ct_U = whiten_bwd(A, H, tuple(aux), ct_G, ct_ld)
        return ct_A, ct_Q, ct_R, None, ct_U


def whiten_gram(lgssm: LGSSM, U):
    """(G, logdet) with G = U^T Sigma_y^-1 U through the blocked filter, the
    Gram in float64, differentiable in (A, Q, R, U) by the closed-form
    adjoint; the working precision is the LGSSM's."""
    n = lgssm.num_steps
    dtype = lgssm.A.dtype
    R = lgssm.R.to(dtype).expand(n)
    U = torch.as_tensor(U, device=lgssm.A.device).to(dtype)
    return _WhitenGram.apply(lgssm.A, lgssm.Q, R, lgssm.H.to(dtype), U)
