"""Parallel (associative-scan) Kalman filter and RTS smoother (Sarkka &
Garcia-Fernandez, arXiv:1905.13002).

Counterpart of ``gpar_at_scale_tpu/ssm/pkalman.py``.  The filter and the
smoother are associative prefix scans over per-step elements, here by
recursive doubling (``_scan``: log2 N levels of one batched combine each)
where the JAX package runs ``jax.lax.associative_scan``.  The same element
algebra is folded blockwise by ``ssm/blocked.py`` and by the CUDA scan
kernels' plain versions, which share ``_filter_elements``, ``_scan`` and
``_combine_smooth`` with this module.

This is the engine of ``filter_impl="associative"`` and of every SDE the
scan kernels cannot take (state dim > 3 or H != e1: sum kernels), for any
state dim and emission row, differentiable by autograd.  Its combines
invert the small d x d matrices by the adjugate for d <= 3
(``_inv_small``, ``_combine_fast``: the blocked engine's algebra) where the
JAX package solves; ``_combine`` is the JAX package's solve-based combine,
held to the adjugate one in the tests.

Filtering element per step k (A_0 = 0, Q_0 = Pinf, so the prior enters at
step 0):

    S_k = H Q_k H^T + R_k          K_k = Q_k H^T / S_k
    A'_k = (I - K_k H) A_k         b'_k = K_k y_k
    C'_k = (I - K_k H) Q_k
    eta'_k = A_k^T H^T y_k / S_k   J'_k = A_k^T H^T H A_k / S_k

b and eta carry a trailing column axis B; A, C, J are shared.  After the
inclusive scan m_k = b_k and P_k = C_k; the predicted moments, innovations
and ll follow elementwise from the one-step shift.
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ssm.kalman import FilterResult, SmoothResult, _ensure_batch
from gpar_at_scale_torch.ssm.markov import LGSSM

_LOG_2PI = 1.8378770664093453


def _scan(fn, elems, reverse=False):
    """Inclusive scan along axis 0 by recursive doubling (log2 n levels of
    one batched ``fn`` each).  ``fn(prev, cur)`` combines the running value
    of the earlier positions in scan order with the current one."""
    if reverse:
        elems = tuple(e.flip(0) for e in elems)
    n = elems[0].shape[0]
    off = 1
    while off < n:
        tail = fn(tuple(e[:-off] for e in elems), tuple(e[off:] for e in elems))
        elems = tuple(torch.cat([e[:off], t], dim=0) for e, t in zip(elems, tail))
        off *= 2
    if reverse:
        elems = tuple(e.flip(0) for e in elems)
    return elems


def _inv_small(Z):
    """Batched inverse of (..., d, d) via the adjugate for d <= 3 (every Z
    inverted here is I + (PSD)(PSD) or a predicted covariance)."""
    d = Z.shape[-1]
    if d == 1:
        return 1.0 / Z
    if d == 2:
        a, b, c, e = Z[..., 0, 0], Z[..., 0, 1], Z[..., 1, 0], Z[..., 1, 1]
        det = a * e - b * c
        adj = torch.stack([torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2)
        return adj / det[..., None, None]
    if d == 3:
        r0, r1, r2 = Z[..., 0, :], Z[..., 1, :], Z[..., 2, :]
        c0 = torch.linalg.cross(r1, r2)
        c1 = torch.linalg.cross(r2, r0)
        c2 = torch.linalg.cross(r0, r1)
        det = (r0 * c0).sum(-1)
        return torch.stack([c0, c1, c2], -1) / det[..., None, None]
    return torch.linalg.inv_ex(Z)[0]


def _filter_elements(lgssm: LGSSM, Y):
    """Per-step scan elements for Y (N, B)."""
    A, Q, H, R = lgssm.A, lgssm.Q, lgssm.H, lgssm.R
    d = lgssm.dim
    I = torch.eye(d, dtype=A.dtype, device=A.device)
    S = torch.einsum("i,nij,j->n", H, Q, H) + R
    K = torch.einsum("nij,j->ni", Q, H) / S[:, None]
    ImKH = I - K[:, :, None] * H[None, None, :]
    A_el = ImKH @ A
    b_el = K[:, :, None] * Y[:, None, :]
    C_el = ImKH @ Q
    HA = torch.einsum("a,nab->nb", H, A)
    eta_el = HA[:, :, None] * (Y / S[:, None])[:, None, :]
    J_el = HA[:, :, None] * HA[:, None, :] / S[:, None, None]
    return A_el, b_el, C_el, eta_el, J_el


def _combine(elem_i, elem_j):
    """Associative combine of filtering elements (i earlier, j later), with
    general (..., d, d) solves (``solve_ex``: no host sync for an error
    check; Z and Z2 have eigenvalues >= 1 since C and J are PSD)."""
    A_i, b_i, C_i, eta_i, J_i = elem_i
    A_j, b_j, C_j, eta_j, J_j = elem_j
    d = A_i.shape[-1]
    I = torch.eye(d, dtype=A_i.dtype, device=A_i.device)
    Z = I + C_i @ J_j
    AjZ = torch.linalg.solve_ex(Z.transpose(-1, -2), A_j.transpose(-1, -2))[0].transpose(-1, -2)
    A_ij = AjZ @ A_i
    b_ij = AjZ @ (b_i + C_i @ eta_j) + b_j
    C_ij = AjZ @ C_i @ A_j.transpose(-1, -2) + C_j
    Z2 = I + J_j @ C_i
    AiTZ2 = torch.linalg.solve_ex(Z2.transpose(-1, -2), A_i)[0].transpose(-1, -2)
    eta_ij = AiTZ2 @ (eta_j - J_j @ b_i) + eta_i
    J_ij = AiTZ2 @ J_j @ A_i + J_i
    return A_ij, b_ij, C_ij, eta_ij, J_ij


def _combine_fast(elem_i, elem_j):
    """Filtering-element combine (i earlier, j later) with the adjugate
    inverse: the algebra of ``_combine``."""
    A_i, b_i, C_i, eta_i, J_i = elem_i
    A_j, b_j, C_j, eta_j, J_j = elem_j
    d = A_i.shape[-1]
    I = torch.eye(d, dtype=A_i.dtype, device=A_i.device)
    AjZ = A_j @ _inv_small(I + C_i @ J_j)
    A_ij = AjZ @ A_i
    b_ij = AjZ @ (b_i + C_i @ eta_j) + b_j
    C_ij = AjZ @ C_i @ A_j.transpose(-1, -2) + C_j
    AiTZ2 = A_i.transpose(-1, -2) @ _inv_small(I + J_j @ C_i)
    eta_ij = AiTZ2 @ (eta_j - J_j @ b_i) + eta_i
    J_ij = AiTZ2 @ J_j @ A_i + J_i
    return A_ij, b_ij, C_ij, eta_ij, J_ij


def parallel_filter(lgssm: LGSSM, y) -> FilterResult:
    """Associative-scan filter: the ``FilterResult`` of the sequential
    ``kalman_filter`` (filtered and predicted moments, innovations, ll) at
    log2 N depth."""
    Y, _ = _ensure_batch(y)
    _, m, P, _, _ = _scan(_combine_fast, _filter_elements(lgssm, Y))
    A, Q, H, R = lgssm.A, lgssm.Q, lgssm.H, lgssm.R
    m_prev = torch.cat([torch.zeros_like(m[:1]), m[:-1]])
    P_prev = torch.cat([torch.zeros_like(P[:1]), P[:-1]])
    mp = A @ m_prev
    Pp = A @ P_prev @ A.transpose(-1, -2) + Q
    S = torch.einsum("a,nab,b->n", H, Pp, H) + R
    v = Y - torch.einsum("a,naB->nB", H, mp)
    ll = -0.5 * (_LOG_2PI + torch.log(S)[:, None] + v * v / S[:, None]).sum(0)
    return FilterResult(m=m, P=P, mp=mp, Pp=Pp, S=S, v=v, ll=ll)


def parallel_logpdf(lgssm: LGSSM, y):
    """log N(y | 0, Sigma) per column through the associative-scan filter."""
    res = parallel_filter(lgssm, y)
    return res.ll[0] if y.ndim == 1 else res.ll


def parallel_decorrelate(lgssm: LGSSM, y):
    """Whitening pass (ll, alpha = v / sqrt(S)) through the associative-scan
    filter; batched over columns."""
    res = parallel_filter(lgssm, y)
    alpha = res.v / torch.sqrt(res.S)[:, None]
    if y.ndim == 1:
        return res.ll[0], alpha[:, 0]
    return res.ll, alpha


def _smoother_elements(lgssm: LGSSM, res: FilterResult, next_step=None):
    """Per-step smoothing elements from the filtered moments, with the
    adjugate inverse: E_k = P_k A_{k+1}^T Pp_{k+1}^-1,
    g_k = m_k - E_k mp_{k+1}, L_k = P_k - E_k Pp_{k+1} E_k^T; the last
    element is (0, m_N, P_N).

    ``next_step``: the transition A1 (d, d) and predicted moments
    mp1 (d, B), Pp1 (d, d) of the step after the series (a later segment's
    first step, ``ssm/segmented.py``); the last element is then a regular
    element toward that step."""
    A, m, P, mp, Pp = lgssm.A, res.m, res.P, res.mp, res.Pp
    d = A.shape[-1]
    if next_step is not None:
        A1, mp1, Pp1 = (torch.as_tensor(x, dtype=A.dtype, device=A.device) for x in next_step)
        A_next = torch.cat([A[1:], A1.reshape(1, d, d)])
        mp_next = torch.cat([mp[1:], mp1.reshape((1,) + mp.shape[1:])])
        Pp_next = torch.cat([Pp[1:], Pp1.reshape(1, d, d)])
        E = P @ A_next.transpose(-1, -2) @ _inv_small(Pp_next)
        return E, m - E @ mp_next, P - E @ Pp_next @ E.transpose(-1, -2)
    E = P[:-1] @ A[1:].transpose(-1, -2) @ _inv_small(Pp[1:])
    g = m[:-1] - E @ mp[1:]
    L = P[:-1] - E @ Pp[1:] @ E.transpose(-1, -2)
    return (
        torch.cat([E, E.new_zeros((1, d, d))]),
        torch.cat([g, m[-1:]]),
        torch.cat([L, P[-1:]]),
    )


def _combine_smooth(later, earlier):
    """Reverse-scan combine: ``later`` is the combined suffix of the later
    steps, ``earlier`` the new earlier step, whose gain applies on the left
    (earlier o later): (E_e E_l, E_e g_l + g_e, E_e L_l E_e^T + L_e)."""
    E_l, g_l, L_l = later
    E_e, g_e, L_e = earlier
    return E_e @ E_l, E_e @ g_l + g_e, E_e @ L_l @ E_e.transpose(-1, -2) + L_e


def parallel_smooth(lgssm: LGSSM, y, filter_result: FilterResult = None) -> SmoothResult:
    """Associative-scan RTS smoother (a reverse scan over the smoothing
    elements): the ``SmoothResult`` of the sequential ``rts_smooth``."""
    Y, single = _ensure_batch(y)
    res = filter_result if filter_result is not None else parallel_filter(lgssm, Y)
    _, ms, Ps = _scan(_combine_smooth, _smoother_elements(lgssm, res), reverse=True)
    H = lgssm.H
    f_mean = torch.einsum("d,ndb->nb", H, ms)
    f_var = torch.einsum("d,nde,e->n", H, Ps, H)
    if single:
        f_mean = f_mean[:, 0]
    return SmoothResult(mean=f_mean, var=torch.clamp(f_var, min=0.0), ll=res.ll, ms=ms, Ps=Ps)
