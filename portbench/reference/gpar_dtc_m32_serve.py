"""Plain reference of the configuration ``gpar_dtc_m32_serve``: q(u) of the
long-series scaled GPAR conditional at given log-parameters, and the exact
predictive at held-out times of a batch of hyperparameter draws against
that q(u).

Model (TudorParas/GPAR-at-scale, ``src/gp/dtc.jl``): y = f_x(X) + f_t(t) +
noise, as in ``gpar_dtc_m32.py``, whose helpers this file loads (the DTC
Gram through the time GP's Kalman filter, the Matern-5/2 SDE, the blocked
prefix scans).  With P = K_uf Sigma^-1 K_fu + K_uu and g = K_uf Sigma^-1 y
at the fitted log-parameters, q(u) = N(K_uu P^-1 g, K_uu P^-1 K_uu), so a
draw's f_x = K_.u K_uu^-1 u over the spliced times has

    mean fx = K_.u P^-1 g,   covariance G G',  G = K_.u L_P^-T,  P = L_P L_P',

K_.u from the draw's output kernel, P and g from the fit (the q(u) a
server caches).  The draw's time GP, observed at the training times with
its noise and unobserved at the held-out ones, smooths the columns
[y - fx | G] (S the smoother, linear in its observations):

    mean = fx_* + (S (y - fx))_*,   var = |G_* - (S G)_*|^2_rows + P_smooth,*

which is the exact limit of the program's splice of the held-out times
with observation noise 1e10.  The smoother is a float64 Kalman filter
(covariances by the (A, C, J) elements, means by an affine scan) and an
RTS pass (the smoothing elements (E, g, L), suffix scans of the affine and
congruence maps), each a prefix scan in blocks of 32 steps, so that a
series of 10^6 steps is a few hundred large tensor operations.

Plain PyTorch only: this file imports nothing of the program.  Precision
as in ``gpar_dtc_m32.py``: float64 throughout for the reference, float32
with TF32 matmuls for the control.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import NamedTuple

import torch


def _load_base():
    path = Path(__file__).resolve().parent / "gpar_dtc_m32.py"
    spec = importlib.util.spec_from_file_location("portbench_reference_gpar_dtc_m32", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


base = _load_base()
F64 = base.F64
REFERENCE, CONTROL = base.REFERENCE, base.CONTROL
mm, inv3 = base.mm, base.inv3
pseudo_inputs = base.pseudo_inputs


class Inputs(NamedTuple):
    """What the benchmark hands both sides, as the program takes them
    (float32): time-sorted training t (n,), X (n, D), y (n,), the
    pseudo-inputs Z (M, D), and the held-out t_star (n*,), X_star (n*, D)."""

    t: torch.Tensor
    X: torch.Tensor
    y: torch.Tensor
    Z: torch.Tensor
    t_star: torch.Tensor
    X_star: torch.Tensor


class QU(NamedTuple):
    w: torch.Tensor  # (M,) P^-1 g
    L_P: torch.Tensor  # (M, M) chol(P)
    u_mean: torch.Tensor  # (M,) the posterior of u: mean
    u_var: torch.Tensor  # (M,) and marginal variances


def q_u(x, inp: Inputs, prec=REFERENCE) -> QU:
    """q(u) at log-parameters x (the fit's)."""
    with base.matmul_precision(prec.tf32), torch.no_grad():
        _, g, Gb, L_uu, _ = base.gram_parts(x, base.Inputs(inp.t, inp.X, inp.y, inp.Z), prec)
        Kuu = L_uu @ L_uu.T
        L_P = torch.linalg.cholesky(Gb + Kuu)
        Bm = torch.linalg.solve_triangular(L_P, Kuu, upper=False)  # L_P^-1 K_uu
        wl = torch.linalg.solve_triangular(L_P, g[:, None], upper=False)  # L_P^-1 g
        w = torch.linalg.solve_triangular(L_P.T, wl, upper=True)[:, 0]
        return QU(w, L_P, (Bm.T @ wl)[:, 0].double(), (Bm * Bm).sum(0).double())


def _congruence(Ei, Li, Ej, Lj):
    """The map M -> L + E M E' composed, e_i applied first."""
    return mm(Ej, Ei), mm(mm(Ej, Li), Ej.transpose(-1, -2)) + Lj


def smooth(ts, observed, U, ell, variance, noise, work):
    """Smoothed means (n, C) of the first state component for the columns U
    (n, C) and its variances (n,): the Matern-5/2 time GP of lengthscale
    ``ell`` and ``variance`` on sorted times ts (float64), observed with
    ``noise`` where ``observed``, in the precision ``work``."""
    lam, Pinf, Nil = base.matern52_sde(ell, variance)
    A, Q = base.transitions(torch.diff(ts).to(work), lam, Pinf, Nil)
    A = torch.cat([torch.zeros_like(A[:1]), A])  # x_0 from the stationary prior
    Q = torch.cat([Pinf[None], Q])
    o = observed.to(work)
    a = A[:, 0, :]
    S = Q[:, 0, 0] + noise
    K = o[:, None] * Q[:, :, 0] / S[:, None]
    EA = A - K[:, :, None] * a[:, None, :]
    EC = Q - S[:, None, None] * K[:, :, None] * K[:, None, :]
    EJ = o[:, None, None] * a[:, :, None] * a[:, None, :] / S[:, None, None]
    _, P, _ = base.blocked_scan((EA, EC, EJ), base.combine)  # filtered covariances
    P = 0.5 * (P + P.transpose(-1, -2))
    Pm = mm(mm(A, torch.cat([torch.zeros_like(P[:1]), P[:-1]])), A.transpose(-1, -2)) + Q
    S = Pm[:, 0, 0] + noise
    K = o[:, None] * Pm[:, :, 0] / S[:, None]
    F = A - K[:, :, None] * a[:, None, :]
    _, m = base.blocked_scan((F, K[:, :, None] * U[:, None, :]), base._affine)  # filtered means
    eye = torch.eye(3, dtype=work, device=A.device)
    A_next = torch.cat([A[1:], torch.zeros_like(A[:1])])
    Pp = mm(mm(A_next, P), A_next.transpose(-1, -2)) + torch.cat([Q[1:], eye[None]])
    E = mm(mm(P, A_next.transpose(-1, -2)), inv3(Pp))
    g = m - mm(E, mm(A_next, m))
    L = P - mm(mm(E, Pp), E.transpose(-1, -2))
    L = 0.5 * (L + L.transpose(-1, -2))
    Er = E.flip(0)
    _, v = base.blocked_scan((Er, g.flip(0)), base._affine)  # smoothed means, last step first
    _, Ms = base.blocked_scan((Er, L.flip(0)), _congruence)
    return v.flip(0)[:, 0, :], Ms.flip(0)[:, 0, 0]


def predict(draws, qu: QU, inp: Inputs, prec=REFERENCE):
    """(mean, var), each (k, n*) in t_star's order, of the k draws' (k, 5)
    log-parameters against q(u)."""
    wd = prec.work
    n = inp.t.shape[0]
    with base.matmul_precision(prec.tf32), torch.no_grad():
        t_all = torch.cat([inp.t, inp.t_star]).to(F64)
        order = torch.argsort(t_all, stable=True)
        ts, observed = t_all[order], order < n
        held = torch.argsort(order, stable=True)[n:]
        V = torch.cat([inp.X, inp.X_star])[order].to(wd)
        ys = torch.cat([inp.y, inp.y.new_zeros(inp.t_star.shape[0])])[order].to(wd)
        Z = inp.Z.to(wd)
        L_P = qu.L_P.to(prec.gram)
        Linv = torch.linalg.solve_triangular(L_P, torch.eye(L_P.shape[0], dtype=L_P.dtype,
                                                            device=L_P.device), upper=False)
        w, LinvT = qu.w.to(wd), Linv.T.to(wd)
        means, variances = [], []
        for x in draws:
            tl, tsig, ol, osig, ns = (v.to(wd) for v in base.unpack(x.to(F64)))
            Kx = base.kernel_matrix(V, Z, ol, osig**2)
            fx, G = Kx @ w, Kx @ LinvT
            sm, sv = smooth(ts, observed, torch.cat([(ys - fx)[:, None], G], 1), tl, tsig**2,
                            ns**2, wd)
            H = G[held] - sm[held, 1:]
            means.append((fx[held] + sm[held, 0]).double())
            variances.append(((H * H).sum(1) + sv[held]).double())
        return torch.stack(means), torch.stack(variances)
