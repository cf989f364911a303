"""Sequential Kalman filter and RTS smoother with batched observation columns.

Counterpart of ``gpar_at_scale_tpu/ssm/kalman.py``: the O(N)-depth oracle
(Joseph-form updates) and the ``filter_impl="sequential"`` engine.  A
Python loop over the N steps, so it is for small N; long series go through
``ssm/blocked.py`` or the CUDA kernels in ``ops/``.

All functions take y of shape (N,) or (N, B); the covariance recursion is
shared by the B columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpar_at_scale_torch.ssm.markov import LGSSM

_LOG_2PI = 1.8378770664093453


class FilterResult(NamedTuple):
    """Per-step filter quantities.

    m:  (N, d, B) filtered means        P:  (N, d, d) filtered covariances
    mp: (N, d, B) predicted means       Pp: (N, d, d) predicted covariances
    S:  (N,)      innovation variances  v:  (N, B)    innovations
    ll: (B,)      log marginal likelihood per column
    """

    m: torch.Tensor
    P: torch.Tensor
    mp: torch.Tensor
    Pp: torch.Tensor
    S: torch.Tensor
    v: torch.Tensor
    ll: torch.Tensor


class SmoothResult(NamedTuple):
    """RTS smoothing output: mean (N, B) and var (N,) of f = H x, the filter
    ll (B,), and the smoothed state moments ms (N, d, B), Ps (N, d, d)."""

    mean: torch.Tensor
    var: torch.Tensor
    ll: torch.Tensor
    ms: torch.Tensor
    Ps: torch.Tensor


def _ensure_batch(y):
    return (y[:, None], True) if y.ndim == 1 else (y, False)


def kalman_filter(lgssm: LGSSM, y) -> FilterResult:
    """Forward filter with batched observation columns."""
    Y, _ = _ensure_batch(y)
    n, d = lgssm.num_steps, lgssm.dim
    H = lgssm.H
    I = torch.eye(d, dtype=lgssm.A.dtype, device=lgssm.A.device)
    m = Y.new_zeros((d, Y.shape[1]))
    P = Y.new_zeros((d, d))
    out = {k: [] for k in ("m", "P", "mp", "Pp", "S", "v", "ll")}
    for k in range(n):
        A, Q, R = lgssm.A[k], lgssm.Q[k], lgssm.R[k]
        mp = A @ m
        Pp = A @ P @ A.T + Q
        S = H @ Pp @ H + R
        v = Y[k] - H @ mp
        K = (Pp @ H) / S
        m = mp + K[:, None] * v[None, :]
        ImKH = I - K[:, None] * H[None, :]
        P = ImKH @ Pp @ ImKH.T + R * torch.outer(K, K)  # Joseph form
        for name, val in zip(out, (m, P, mp, Pp, S, v)):
            out[name].append(val)
        out["ll"].append(-0.5 * (_LOG_2PI + torch.log(S) + v * v / S))
    st = {k: torch.stack(v) for k, v in out.items()}
    return FilterResult(
        m=st["m"], P=st["P"], mp=st["mp"], Pp=st["Pp"], S=st["S"], v=st["v"],
        ll=st["ll"].sum(0),
    )


def logpdf(lgssm: LGSSM, y):
    """log N(y | 0, Sigma) via the innovations decomposition."""
    res = kalman_filter(lgssm, y)
    return res.ll[0] if y.ndim == 1 else res.ll


def decorrelate(lgssm: LGSSM, y):
    """Whitening pass: (lml, alpha) with alpha = L^-1 y for the innovations
    Cholesky factor L of Sigma; batched over columns."""
    res = kalman_filter(lgssm, y)
    alpha = res.v / torch.sqrt(res.S)[:, None]
    if y.ndim == 1:
        return res.ll[0], alpha[:, 0]
    return res.ll, alpha


def log_det_cov(lgssm: LGSSM):
    """log det(Sigma) = sum_k log S_k, from the innovation variances: no
    dense noise matrix."""
    res = kalman_filter(lgssm, lgssm.A.new_zeros((lgssm.num_steps,)))
    return torch.log(res.S).sum()


def rts_smooth(lgssm: LGSSM, y, filter_result: FilterResult = None) -> SmoothResult:
    """Rauch-Tung-Striebel smoother; batched means share one covariance pass."""
    Y, single = _ensure_batch(y)
    res = filter_result if filter_result is not None else kalman_filter(lgssm, Y)
    n = res.m.shape[0]
    ms, Ps = [res.m[-1]], [res.P[-1]]
    for k in range(n - 2, -1, -1):
        A_next, Pp_next = lgssm.A[k + 1], res.Pp[k + 1]
        G = torch.linalg.solve(Pp_next, A_next @ res.P[k]).T
        ms.append(res.m[k] + G @ (ms[-1] - res.mp[k + 1]))
        Ps.append(res.P[k] + G @ (Ps[-1] - Pp_next) @ G.T)
    ms = torch.stack(ms[::-1])
    Ps = torch.stack(Ps[::-1])
    H = lgssm.H
    f_mean = torch.einsum("d,ndb->nb", H, ms)
    f_var = torch.einsum("d,nde,e->n", H, Ps, H)
    if single:
        f_mean = f_mean[:, 0]
    return SmoothResult(mean=f_mean, var=torch.clamp(f_var, min=0.0), ll=res.ll, ms=ms, Ps=Ps)


def posterior_sample(generator: torch.Generator, lgssm: LGSSM, y, num_samples: int = 1):
    """Joint posterior draws of f = H x given one observation column, by
    forward filtering and backward sampling (the reference's
    ``posterior_rand``, ``src/gp/tmp.jl:167``): (num_samples, N).  The
    O(N)-depth oracle of ``ssm/blocked.py::blocked_posterior_sample``;
    standard normals come from ``generator``, on its device."""
    Y, _ = _ensure_batch(y)
    if Y.shape[1] != 1:
        raise ValueError("posterior_sample expects a single observation column")
    res = kalman_filter(lgssm, Y)
    n, d = lgssm.num_steps, lgssm.dim
    dtype, dev = lgssm.A.dtype, lgssm.A.device
    S = num_samples
    eye = torch.eye(d, dtype=dtype, device=dev)
    jitter = 1e-12 if dtype == torch.float64 else 1e-8

    def noise(P):
        xi = torch.randn((S, d), generator=generator, dtype=dtype, device=generator.device)
        return xi.to(dev) @ torch.linalg.cholesky(P + jitter * eye).T

    xs = [res.m[-1][:, 0][None, :] + noise(res.P[-1])]
    for k in range(n - 2, -1, -1):
        Pp_next = res.Pp[k + 1]
        G = torch.linalg.solve(Pp_next, lgssm.A[k + 1] @ res.P[k]).T
        cond_mean = res.m[k][:, 0][None, :] + (xs[-1] - res.mp[k + 1][:, 0][None, :]) @ G.T
        xs.append(cond_mean + noise(res.P[k] - G @ Pp_next @ G.T))
    x = torch.stack(xs[::-1])  # (N, S, d)
    return torch.einsum("d,nsd->sn", lgssm.H.to(dtype), x)
