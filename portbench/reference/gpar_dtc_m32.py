"""Plain reference of the configuration ``gpar_dtc_m32``: the DTC evidence
bound of one scaled GPAR conditional, its gradient, Adam on it, and q(u).

Model (TudorParas/GPAR-at-scale, ``src/gp/dtc.jl``): y = f_x(X) + f_t(t) +
noise, f_x a Matern-5/2 GP over the D previous outputs approximated by M
pseudo-points Z, f_t a Matern-5/2 GP on time, which is exact as the
3-dimensional state-space model it is.  With Sigma = K_t + s2 I,

    bound = -1/2 [N log 2 pi + log det Sigma + log det P - log det K_uu
                  + y' Sigma^-1 y - g' P^-1 g],
    g = K_fu' Sigma^-1 y,  P = K_fu' Sigma^-1 K_fu + K_uu,
    K_uu = k_x(Z, Z) + s2 I + 1e-6 mean(diag) I.

Sigma^-1 is applied through the Kalman filter of the time GP, run as a
parallel prefix scan (Saerkkae and Garcia-Fernandez, "Temporal
parallelization of Bayesian smoothers", IEEE TAC 2021): the covariance
elements (A, C, J), then the filtered means of all columns [y | K_fu] as
an affine scan, each in blocks of 32 steps (a fold inside all blocks at
once, the blocks' totals by doubling, one combine per step after), so
every pass is a few large tensor operations.  The series runs in
stretches of 2^22 steps, each entered with the filtered state of the one
before; the gradient in the 5 log-parameters is reverse mode with every
stretch recomputed in the backward pass, so that N = 10^7 fits.

Plain PyTorch only: this file imports nothing of the program.  Precision
is an argument: ``work`` for the O(N) side, ``gram`` for the Gram and the
M x M algebra, ``tf32`` for reduced-precision matmuls; the reference runs
float64 throughout and the control below that.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple

import torch
import torch.utils.checkpoint

LOG_2PI = math.log(2.0 * math.pi)
SQRT5 = math.sqrt(5.0)
F64 = torch.float64


class Precision(NamedTuple):
    work: torch.dtype = F64  # O(N) side: kernels, discretization, scans
    gram: torch.dtype = F64  # W'W and the M x M algebra
    tf32: bool = False


REFERENCE = Precision()
# the step below the configuration's precision (float32 with float64 Gram,
# TF32 off): float32 with TF32 matmuls on the O(N) side, float32 Gram
CONTROL = Precision(torch.float32, torch.float32, True)


@contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def positive(p):
    """Log-parameter -> value: exp(p) + 1e-3 (the model's transform)."""
    return torch.exp(p) + 1e-3


def unpack(x):
    """(time l, time sigma, output l, output sigma, noise sigma)."""
    return tuple(positive(x[i]) for i in range(5))


def matern52(r2, variance):
    s = SQRT5 * torch.sqrt(r2 + 1e-36)
    return variance * (1.0 + s + (5.0 / 3.0) * r2) * torch.exp(-s)


def kernel_matrix(A, B, ell, variance):
    """Matern-5/2 Gram of the rows of A (n, D) against B (m, D)."""
    r2 = 0.0
    for d in range(A.shape[1]):
        diff = (A[:, d, None] - B[None, :, d]) / ell
        r2 = r2 + diff * diff
    return matern52(r2, variance)


def mm(a, b):
    """a (..., 3, 3) @ b (..., 3, k) as three broadcast products: batched
    3 x 3 products run far below the card's rate as matmuls."""
    return (a[..., :, 0, None] * b[..., None, 0, :] + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


def inv3(M):
    """Inverse of a stack of 3 x 3 matrices by the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    co = [e * i - f * h, -(d * i - f * g), d * h - e * g,
          -(b * i - c * h), a * i - c * g, -(a * h - b * g),
          b * f - c * e, -(a * f - c * d), a * e - b * d]
    det = a * co[0] + b * co[1] + c * co[2]
    adj = torch.stack([torch.stack([co[0], co[3], co[6]], -1),
                       torch.stack([co[1], co[4], co[7]], -1),
                       torch.stack([co[2], co[5], co[8]], -1)], -2)
    return adj / det[..., None, None]


def matern52_sde(ell, variance):
    """(lam, Pinf, Nil) of the Matern-5/2 time GP: F = Nil - lam I."""
    lam = SQRT5 / ell
    z, o = torch.zeros_like(lam), torch.ones_like(lam)
    kappa = variance * lam**2 / 3.0
    Pinf = torch.stack([torch.stack([variance, z, -kappa]), torch.stack([z, kappa, z]),
                        torch.stack([-kappa, z, lam**4 * variance])])
    Nil = torch.stack([torch.stack([lam, o, z]), torch.stack([z, lam, o]),
                       torch.stack([-lam**3, -3.0 * lam**2, -2.0 * lam])])
    return lam, Pinf, Nil


def transitions(dt, lam, Pinf, Nil):
    """A_k = expm(F dt_k), Q_k = Pinf - A_k Pinf A_k' for gaps dt (n,)."""
    dt = dt[:, None, None]
    eye = torch.eye(3, dtype=dt.dtype, device=dt.device)
    A = torch.exp(-lam * dt) * (eye + Nil * dt + mm(Nil, Nil) * (0.5 * dt * dt))
    Q = Pinf - mm(mm(A, Pinf), A.transpose(-1, -2))
    return A, 0.5 * (Q + Q.transpose(-1, -2))


def combine(Ai, Ci, Ji, Aj, Cj, Jj):
    """The filtering elements' associative operation, e_i earlier than e_j
    (the (A, C, J) parts; b and eta are not needed for covariances)."""
    eye = torch.eye(3, dtype=Ai.dtype, device=Ai.device)
    Minv = inv3(eye + mm(Ci, Jj))
    AjM = mm(Aj, Minv)
    MAi = mm(Minv, Ai)  # (I + J_j C_i)^-1 J_j = J_j (I + C_i J_j)^-1
    return (mm(AjM, Ai), mm(mm(AjM, Ci), Aj.transpose(-1, -2)) + Cj,
            mm(mm(Ai.transpose(-1, -2), Jj), MAi) + Ji)


def _blocks(x, nb, L):
    """(n, ...) -> (nb, L, ...), padding the tail with copies of the last
    row (the padding's results are dropped)."""
    n = x.shape[0]
    if nb * L > n:
        x = torch.cat([x, x[-1:].expand(nb * L - n, *x.shape[1:])])
    return x.reshape(nb, L, *x.shape[1:])


def _prefix_doubling(elems, op):
    """Inclusive prefix of a sequence of elements under ``op`` by doubling."""
    n, s = elems[0].shape[0], 1
    while s < n:
        new = op(*(e[:-s] for e in elems), *(e[s:] for e in elems))
        elems = tuple(torch.cat([e[:s], f]) for e, f in zip(elems, new))
        s *= 2
    return elems


def blocked_scan(elems, op, L=32):
    """Inclusive prefix of n elements under ``op`` in blocks of L: a
    sequential fold inside every block (all blocks at once), the blocks'
    totals by doubling, then each block's prefixes combined with the
    total of all blocks before it."""
    n = elems[0].shape[0]
    nb = -(-n // L)
    cols = [_blocks(e, nb, L).unbind(1) for e in elems]  # one backward op, not L
    pre = [[c[0]] for c in cols]
    for j in range(1, L):
        nxt = op(*(p[-1] for p in pre), *(c[j] for c in cols))
        for p, x in zip(pre, nxt):
            p.append(x)
    pre = [torch.stack(p, 1) for p in pre]  # (nb, L, ...)
    tot = _prefix_doubling(tuple(p[:, -1] for p in pre), op)
    if nb > 1:
        carry = tuple(t[:-1, None].expand(-1, L, *t.shape[1:]) for t in tot)
        rest = op(*carry, *(p[1:] for p in pre))
        pre = [torch.cat([p[:1], r]) for p, r in zip(pre, rest)]
    return tuple(p.reshape(nb * L, *p.shape[2:])[:n] for p in pre)


def _affine(Fi, ci, Fj, cj):
    return mm(Fj, Fi), mm(Fj, ci) + cj


def whiten_chunk(A, Q, R, U, P_prev, m_prev):
    """The Kalman filter over one stretch of steps, entered with the
    filtered (P_prev (3, 3), m_prev (3, B)) of the step before it, and
    A_k, Q_k the transitions into each step.  Returns (W (n, B), the sum of
    log S, and the filtered P, m of the last step); W are the columns U
    whitened by Sigma^-1/2 (the standardized innovations)."""
    Pm0 = mm(mm(A[0], P_prev), A[0].T) + Q[0]
    Ae = torch.cat([torch.zeros_like(A[:1]), A[1:]])
    Qe = torch.cat([Pm0[None], Q[1:]])
    S = Qe[:, 0, 0] + R
    K = Qe[:, :, 0] / S[:, None]
    a = Ae[:, 0, :]
    EA = Ae - K[:, :, None] * a[:, None, :]
    EC = Qe - S[:, None, None] * K[:, :, None] * K[:, None, :]
    EJ = a[:, :, None] * a[:, None, :] / S[:, None, None]
    _, P, _ = blocked_scan((EA, EC, EJ), combine)  # filtered covariances
    P = 0.5 * (P + P.transpose(-1, -2))
    Pprev = torch.cat([P_prev[None], P[:-1]])
    Pm = mm(mm(A, Pprev), A.transpose(-1, -2)) + Q  # predicted covariances
    S = Pm[:, 0, 0] + R
    K = Pm[:, :, 0] / S[:, None]
    a = A[:, 0, :]
    F = A - K[:, :, None] * a[:, None, :]
    c = K[:, :, None] * U[:, None, :]
    c = torch.cat([c[:1] + mm(F[0], m_prev)[None], c[1:]])
    F = torch.cat([torch.zeros_like(F[:1]), F[1:]])
    _, m = blocked_scan((F, c), _affine)  # filtered means
    m_shift = torch.cat([m_prev[None], m[:-1]])
    W = (U - (a[:, :, None] * m_shift).sum(1)) / torch.sqrt(S)[:, None]
    return W, torch.log(S).sum(), P[-1], m[-1]


class Inputs(NamedTuple):
    """What the benchmark hands both sides: time-sorted t (n,), X (n, D),
    y (n,) as the program takes them (float32), and the pseudo-inputs Z."""

    t: torch.Tensor
    X: torch.Tensor
    y: torch.Tensor
    Z: torch.Tensor


def pseudo_inputs(X, m):
    """M evenly strided rows (linspace(0, n - 1, M) truncated), the model's
    choice of pseudo-points."""
    n = X.shape[0]
    if m >= n:
        return X
    return X[torch.linspace(0, n - 1, m, dtype=F64).to(torch.int64).to(X.device)]


CHUNK = 1 << 22  # steps per stretch of the series


def _stretch(t_prev, t, X, y, Z, x, prec: Precision, P_prev, m_prev, first: bool):
    """(W'W, sum log S, P, m at the end) of one stretch of the series."""
    tl, ts, ol, osig, ns = (v.to(prec.work) for v in unpack(x.to(F64)))
    wd = prec.work
    lam, Pinf, Nil = matern52_sde(tl, ts**2)
    dt = torch.diff(torch.cat([t_prev, t]).to(wd))
    A, Q = transitions(dt, lam, Pinf, Nil)
    if first:  # x_0 from the stationary prior
        A = torch.cat([torch.zeros_like(A[:1]), A[1:]])
        Q = torch.cat([Pinf[None], Q[1:]])
    Kfu = kernel_matrix(X.to(wd), Z.to(wd), ol, osig**2)
    U = torch.cat([y.to(wd)[:, None], Kfu], 1)
    W, logdet, P, m = whiten_chunk(A, Q, ns**2, U, P_prev, m_prev)
    W = W.to(prec.gram)
    return W.T @ W, logdet.to(prec.gram), P, m


def gram_parts(x, inp: Inputs, prec: Precision):
    """(aa, g, Gb, L_uu, log det Sigma) at log-parameters x.  The series
    runs in stretches of CHUNK steps, each entered with the filtered state
    of the last; under autograd each stretch is recomputed in the backward
    pass (checkpointed), so memory holds one stretch's graph."""
    n, B = inp.y.shape[0], inp.Z.shape[0] + 1
    wd, gd = prec.work, prec.gram
    P = torch.zeros(3, 3, dtype=wd, device=inp.y.device)
    m = torch.zeros(3, B, dtype=wd, device=inp.y.device)
    G, logdet = 0.0, 0.0
    grad = torch.is_grad_enabled() and x.requires_grad
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        args = (inp.t[max(s - 1, 0):max(s, 1)], inp.t[s:e], inp.X[s:e], inp.y[s:e], inp.Z, x, prec,
                P, m, s == 0)
        if grad:
            Gc, lc, P, m = torch.utils.checkpoint.checkpoint(_stretch, *args, use_reentrant=False)
        else:
            Gc, lc, P, m = _stretch(*args)
        G, logdet = G + Gc, logdet + lc
    tl, ts, ol, osig, ns = (v.to(gd) for v in unpack(x.to(F64)))
    Z = inp.Z.to(gd)
    Kuu = kernel_matrix(Z, Z, ol, osig**2)
    eye = torch.eye(B - 1, dtype=gd, device=Kuu.device)
    Kuu = Kuu + ns**2 * eye
    Kuu = Kuu + 1e-6 * torch.diagonal(Kuu).mean() * eye
    L_uu = torch.linalg.cholesky(Kuu)
    return G[0, 0], G[1:, 0], G[1:, 1:], L_uu, logdet


def objective(x, inp: Inputs, prec: Precision = REFERENCE):
    """The negative DTC bound at log-parameters x (the training loss)."""
    with matmul_precision(prec.tf32):
        aa, g, Gb, L_uu, logdet = gram_parts(x, inp, prec)
        L_P = torch.linalg.cholesky(Gb + L_uu @ L_uu.T)
        wp = torch.linalg.solve_triangular(L_P, g[:, None], upper=False)[:, 0]
        logdet_lam = 2.0 * (torch.log(torch.diagonal(L_P)).sum()
                            - torch.log(torch.diagonal(L_uu)).sum())
        n = inp.y.shape[0]
        return 0.5 * (n * LOG_2PI + logdet + logdet_lam + aa - (wp * wp).sum())


def value_and_grad(x, inp: Inputs, prec: Precision = REFERENCE):
    """(loss, gradient (5,)) in float64, by reverse mode through the
    checkpointed stretches."""
    x = x.to(F64).detach().clone().requires_grad_(True)
    with torch.enable_grad():
        v = objective(x, inp, prec)
        (g,) = torch.autograd.grad(v, x)
    return v.detach().double(), g.double()


class Trajectory(NamedTuple):
    losses: list  # loss at x_0 .. x_{k-1}
    grads: list  # gradient at x_0 .. x_{k-1}
    params: list  # x_0 .. x_k


def adam_follow(x0, inp: Inputs, steps, lr=5e-2, prec: Precision = REFERENCE):
    """``steps`` Adam steps (beta 0.9 / 0.999, eps 1e-8, bias-corrected)
    from x0 on the loss, in float64."""
    x = x0.to(F64).clone()
    m1, m2 = torch.zeros_like(x), torch.zeros_like(x)
    out = Trajectory([], [], [x.clone()])
    for k in range(1, steps + 1):
        v, g = value_and_grad(x, inp, prec)
        out.losses.append(v)
        out.grads.append(g)
        m1 = 0.9 * m1 + 0.1 * g
        m2 = 0.999 * m2 + 0.001 * g * g
        denom = torch.sqrt(m2) / math.sqrt(1.0 - 0.999**k) + 1e-8
        x = x - (lr / (1.0 - 0.9**k)) * m1 / denom
        out.params.append(x.clone())
    return out


def q_u(x, inp: Inputs, prec: Precision = REFERENCE):
    """The posterior of the pseudo-point values u at log-parameters x:
    (mean (M,), marginal variances (M,)), u ~ N(K_uu P^-1 g, K_uu P^-1 K_uu)."""
    with matmul_precision(prec.tf32):
        aa, g, Gb, L_uu, logdet = gram_parts(x, inp, prec)
        Kuu = L_uu @ L_uu.T
        L_P = torch.linalg.cholesky(Gb + Kuu)
        B = torch.linalg.solve_triangular(L_P, Kuu, upper=False)  # L_P^-1 K_uu
        w = torch.linalg.solve_triangular(L_P, g[:, None], upper=False)[:, 0]
        return (B.T @ w).double(), (B * B).sum(0).double()
