"""Plain reference of the configuration ``gpar_eeg_m156``: q(u) of the EEG
scaled conditional and its predictive for a batch of hyperparameter draws.

Model (TudorParas/GPAR-at-scale, ``examples/eeg.jl``; Requeima et al.,
AISTATS 2019): y = f_x(X) + f_t(t) + noise over N training times, f_x a
Matern-5/2 GP over the D conditioning channels with M pseudo-points Z = X,
f_t a Matern-5/2 GP on time, Sigma = K_t + s2 I dense (N = 156).

q(u) at the fitted log-parameters, whitened as eps = L_uu^-1 u:
    D = L_uu^-1 (K_uf Sigma^-1 K_fu) L_uu^-T + I,  m_eps = D^-1 L_uu^-1 g,
    K_uu = k_x(Z, Z) + s2 I + 1e-6 mean(diag) I,  g = K_uf Sigma^-1 y.

The predictive of draw b at the test points, with that q(u) and the
draw's own kernels (Phi = K_.u L_uu^-T, G = Phi L_D^-T, fbar = Phi m_eps):
    mean = fbar_* + K_*n Sigma_b^-1 (y - fbar_n)
    var  = |G_* - K_*n Sigma_b^-1 G_n|^2_rows + k_t(*, *) - diag(K_*n Sigma_b^-1 K_n*)
which is the exact limit of the program's splice of the test times with
observation noise 1e10.

Plain PyTorch only; imports nothing of the program.  ``dtype`` and
``tf32`` set the precision: float64 for the reference, float32 with TF32
matmuls for the control.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple

import torch

SQRT5 = math.sqrt(5.0)
F64 = torch.float64


class Precision(NamedTuple):
    dtype: torch.dtype = F64
    tf32: bool = False


REFERENCE = Precision()
# the step below the configuration's float32 with TF32 off
CONTROL = Precision(torch.float32, True)


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
    return torch.exp(p) + 1e-3


def matern52(r2, variance):
    s = SQRT5 * torch.sqrt(r2 + 1e-36)
    return variance * (1.0 + s + (5.0 / 3.0) * r2) * torch.exp(-s)


def kernel_matrix(A, B, ell, variance):
    """Matern-5/2 Gram of A (..., n, D) against B (m, D); ell and variance
    scalars or (b,) batches (then the result is (b, n, m))."""
    ell = torch.as_tensor(ell, dtype=A.dtype, device=A.device)
    variance = torch.as_tensor(variance, dtype=A.dtype, device=A.device)
    if ell.ndim == 1:
        ell, variance = ell[:, None, None], variance[:, None, None]
    r2 = 0.0
    for d in range(A.shape[-1]):
        diff = (A[..., :, d, None] - B[None, :, d]) / ell
        r2 = r2 + diff * diff
    return matern52(r2, variance)


class Inputs(NamedTuple):
    """What the benchmark hands both sides (float32 as the program takes
    them): training times t (n,), inputs X (n, D), outputs y (n,), test
    times t_star (n*,) and inputs X_star (n*, D); Z = X."""

    t: torch.Tensor
    X: torch.Tensor
    y: torch.Tensor
    t_star: torch.Tensor
    X_star: torch.Tensor


class QU(NamedTuple):
    m_eps: torch.Tensor
    L_D: torch.Tensor
    L_uu: torch.Tensor


def q_u(x, inp: Inputs, prec: Precision = REFERENCE) -> QU:
    """q(u) at the log-parameters x (5,)."""
    with matmul_precision(prec.tf32):
        dt = prec.dtype
        tl, ts, ol, osig, ns = (positive(v) for v in x.to(F64).to(dt))
        t, X, y = inp.t.to(dt), inp.X.to(dt), inp.y.to(dt)
        n = t.shape[0]
        eye_n = torch.eye(n, dtype=dt, device=t.device)
        Sigma = kernel_matrix(t[:, None], t[:, None], tl, ts**2) + ns**2 * eye_n
        L = torch.linalg.cholesky(Sigma)
        Kfu = kernel_matrix(X, X, ol, osig**2)
        Kuu = Kfu + ns**2 * eye_n
        Kuu = Kuu + 1e-6 * torch.diagonal(Kuu).mean() * eye_n
        L_uu = torch.linalg.cholesky(Kuu)
        W = torch.linalg.solve_triangular(L, torch.cat([y[:, None], Kfu], 1), upper=False)
        alpha, beta = W[:, 0], W[:, 1:]
        g, Gb = beta.T @ alpha, beta.T @ beta
        A = torch.linalg.solve_triangular(L_uu, Gb, upper=False)
        AAt = torch.linalg.solve_triangular(L_uu, A.T, upper=False)
        Lam = AAt + eye_n
        L_D = torch.linalg.cholesky(0.5 * (Lam + Lam.T))
        r = torch.linalg.solve_triangular(L_uu, g[:, None], upper=False)
        m_eps = torch.cholesky_solve(r, L_D)[:, 0]
        return QU(m_eps, L_D, L_uu)


def predict(P, qu: QU, inp: Inputs, prec: Precision = REFERENCE):
    """(mean, var) (b, n*) of the draws P (b, 5) against the shared q(u)."""
    with matmul_precision(prec.tf32):
        dt = prec.dtype
        vals = positive(P.to(F64)).to(dt)
        tl, ts, ol, osig, ns = (vals[:, i] for i in range(5))
        t, X, y = inp.t.to(dt), inp.X.to(dt), inp.y.to(dt)
        ts_, Xs = inp.t_star.to(dt), inp.X_star.to(dt)
        n = t.shape[0]
        m_eps, L_D, L_uu = (v.to(dt) for v in qu)
        V = torch.cat([X, Xs])  # (n + n*, D)
        K_all = kernel_matrix(V, X, ol, osig**2)  # (b, n + n*, M)
        b, n_all, m = K_all.shape
        Phi = torch.linalg.solve_triangular(
            L_uu, K_all.reshape(b * n_all, m).T, upper=False).T  # K L_uu^-T
        G = torch.linalg.solve_triangular(L_D, Phi.T, upper=False).T.reshape(b, n_all, m)
        fbar = (Phi @ m_eps).reshape(b, n_all)
        eye_n = torch.eye(n, dtype=dt, device=t.device)
        Sigma = kernel_matrix(t[:, None], t[:, None], tl, ts**2) + (ns**2)[:, None, None] * eye_n
        L = torch.linalg.cholesky(Sigma)
        Ksn = kernel_matrix(ts_[:, None], t[:, None], tl, ts**2)  # (b, n*, n)
        rhs = torch.cat([(y - fbar[:, :n])[..., None], G[:, :n], Ksn.transpose(-1, -2)], -1)
        sol = torch.cholesky_solve(rhs, L)  # Sigma^-1 [r | G_n | K_n*]
        mean = fbar[:, n:] + (Ksn @ sol[..., :1])[..., 0]
        H = G[:, n:] - Ksn @ sol[..., 1:1 + m]
        prior = (ts**2)[:, None]
        var = (H * H).sum(-1) + prior - (Ksn * sol[..., 1 + m:].transpose(-1, -2)).sum(-1)
        return mean.double(), var.double()
