"""Fully Bayesian GPAR: samplers over kernel hyperparameters.

Counterpart of ``gpar_at_scale_tpu/models/bayes.py``: NUTS over the exact,
temporal and DTC log densities of one GPAR conditional, and the predictive
marginalized over the hyperparameter posterior instead of the type-II
point estimate.  The log posterior of one conditional is

    log p(y | theta)  [exact | Kalman | DTC bound]
  + log p(theta)      [N(0, prior_scale^2) on the log-parameters].

The logposts take one (k,) point or a (C, k) batch of chains and return ()
or (C,); each chain's value depends on its own row only, and equals the
value of that row alone.

* ``make_conditional_logpost`` (DTC) up to ``DENSE_N_MAX`` steps builds
  the C chains' temporal covariances as one batch and whitens their
  [y | K_fu] columns in one call: K6a with its batch axis under
  ``engine.pallas_dense`` (K6c in its VJP), ``torch.linalg`` otherwise.
  Above it each chain's columns go through the scan kernels (``gp/dtc.py``'s
  kernel path, one series per call).  Either way the whitened Gram and
  the M x M algebra after it run batched in float64, as every scan
  engine of ``gp/dtc.py`` forms its Gram: with Z = X (M = N = 156, the EEG
  conditional) P = G_b + K_uu reaches a condition number of 5e7 at long
  output lengthscales, and the float32 bound missed the float64 one by
  4 nats there (2.6%), which stranded NUTS chains at step size 0 on the
  CPU.  The exact likelihood factors the batch in the working precision
  (K6a, K6b under the switch).
* ``make_temporal_logpost`` loops over the chains: the sequential Kalman
  filter up to ``DENSE_N_MAX`` steps (the JAX package's engine), the
  kernel path above (``ops/grad.py::logpdf_markov_pallas``: K1/K2 forward,
  K4a/K4b backward, float32), as ``models/gpar.py`` does for output 1 --
  the JAX package runs its sequential filter at every N, and the port's
  sequential filter is a Python loop of N steps.

A factorization that fails for one chain (the float32 "Cholesky cliff" at
extreme hyperparameters) makes that chain's value -inf, read from the
factorization's info word; the JAX package gets NaN there, which its NUTS
treats the same way.  The other chains are untouched.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from gpar_at_scale_torch.device import resolve_device
from gpar_at_scale_torch.gp.dtc import (
    DENSE_N_MAX,
    _scan_gram,
    compute_q_u,
    predict_scaled,
    whiten_ex,
)
from gpar_at_scale_torch.inference.hmc import value_and_grad
from gpar_at_scale_torch.inference.nuts import NUTSResult, nuts
from gpar_at_scale_torch.kernels import Matern52, gpar_kernel, time_kernel_only
from gpar_at_scale_torch.ssm.kalman import logpdf as ssm_logpdf
from gpar_at_scale_torch.ssm.markov import lgssm_of
from gpar_at_scale_torch.utils.params import unpack_gp, unpack_gpar
from gpar_at_scale_torch.utils.psd import (
    cholesky_psd_ex,
    default_jitter,
    logdet_from_chol,
    solve_lower,
)

_LOG_2PI = 1.8378770664093453


def _as(x, dtype, dev):
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def _sorted_by_time(t, dtype, dev, *cols):
    t = _as(t, dtype, dev)
    order = torch.argsort(t, stable=True)
    return (t[order],) + tuple(_as(c, dtype, dev)[order] for c in cols)


def _chains(params):
    """(k,) or (C, k) -> ((C, k), squeeze)."""
    return (params[None], True) if params.ndim == 1 else (params, False)


def _logpost(loglik, prior_scale):
    """The logpost of a batched ``loglik(params (C, k)) -> (ll (C,), ok (C,))``:
    ll + the prior where ok, -inf where a factorization failed."""

    def logpost(params):
        p, squeeze = _chains(params)
        ll, ok = loglik(p)
        prior = -0.5 * (p * p).sum(-1) / prior_scale**2
        lp = torch.where(ok, ll.to(p.dtype) + prior, -torch.inf)
        return lp[0] if squeeze else lp

    return logpost


def make_conditional_logpost(
    t,
    X_prev,
    y,
    *,
    likelihood: str = "dtc",  # 'exact' | 'dtc'
    Z=None,
    time_family=Matern52,
    out_family=Matern52,
    prior_scale: float = 2.0,
    dtype=torch.float64,
    uu_ridge="auto",
    device=None,
) -> Callable:
    """Log posterior over the (5,) log-parameters of one conditional GP, for
    one point or a (C, 5) batch of chains.

    uu_ridge: ``gp/dtc.py``'s; None gives the un-ridged bound."""
    if likelihood not in ("exact", "dtc"):
        raise ValueError(f"unknown likelihood {likelihood!r}")
    if likelihood == "dtc" and Z is None:
        raise ValueError("dtc likelihood requires inducing inputs Z")
    dev = resolve_device(device)
    t_s, X_s, y_s = _sorted_by_time(t, dtype, dev, X_prev, y)
    n = t_s.shape[0]
    t2 = t_s[:, None]
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    def col(x):
        return x[:, None, None]

    def exact(p):
        tl, ts, ol, osig, ns = (col(v) for v in unpack_gpar(p.T))
        k = gpar_kernel(time_family, out_family, 1 + X_s.shape[1], tl, ts, ol, osig)
        X = torch.cat([t2, X_s], dim=1)
        L, info = cholesky_psd_ex(k(X, X) + ns**2 * eye_n)
        alpha = solve_lower(L, y_s.expand(p.shape[0], n))
        ll = -0.5 * (n * _LOG_2PI + logdet_from_chol(L) + (alpha * alpha).sum(-1))
        return ll, info == 0

    Z = None if Z is None else _as(Z, dtype, dev)

    def dtc(p):
        C = p.shape[0]
        tl, ts, ol, osig, ns = unpack_gpar(p.T)
        nv = ns**2
        out_k = out_family(lengthscale=col(ol), variance=col(osig) ** 2)
        Kuu = out_k(Z, Z)
        ridge = nv if isinstance(uu_ridge, str) and uu_ridge == "auto" else uu_ridge
        if ridge is not None:
            Kuu = Kuu + col(torch.as_tensor(ridge, dtype=dtype, device=dev).expand(C)) * torch.eye(
                Z.shape[0], dtype=dtype, device=dev)
        batch = torch.cat([y_s.expand(C, n)[:, :, None], out_k(X_s, Z)], dim=2)  # (C, N, M + 1)
        if n <= DENSE_N_MAX:
            Sigma = time_kernel_only(time_family, col(tl), col(ts))(t2, t2) + col(nv) * eye_n
            white, logdet_noise, info_w = whiten_ex(Sigma, batch)
            white = white.double()
            G = white.transpose(-1, -2) @ white
        else:
            grams = [_scan_gram("pallas", lgssm_of(time_kernel_only(time_family, tl[c], ts[c]),
                                                   t_s, nv[c], dtype), batch[c]) for c in range(C)]
            G = torch.stack([gr[0] for gr in grams])
            logdet_noise = torch.stack([gr[1] for gr in grams])
            info_w = torch.zeros(C, dtype=torch.int32, device=dev)
        # the M x M algebra in float64 (the P-form of gp/dtc.py::dtc_objective,
        # P = Gb + K_uu), K_uu factored with the working precision's jitter
        aa, g, Gb = G[:, 0, 0], G[:, 1:, 0], G[:, 1:, 1:]
        L_uu, info_u = cholesky_psd_ex(Kuu.double(), default_jitter(Kuu.dtype))
        L_P, info_p = torch.linalg.cholesky_ex(Gb + L_uu @ L_uu.transpose(-1, -2))
        wp = solve_lower(L_P, g)
        logdet_lam = logdet_from_chol(L_P) - logdet_from_chol(L_uu)
        ll = -0.5 * (n * _LOG_2PI + logdet_noise + logdet_lam + aa - (wp * wp).sum(-1))
        return ll, (info_w == 0) & (info_u == 0) & (info_p == 0)

    return _logpost(exact if likelihood == "exact" else dtc, prior_scale)


def make_temporal_logpost(
    t, y, *, time_family=Matern52, prior_scale: float = 2.0, dtype=torch.float64, device=None
) -> Callable:
    """Log posterior over the (3,) log-parameters of the temporal GP of
    output 1 (O(N) per chain), for one point or a (C, 3) batch."""
    dev = resolve_device(device)
    t_s, y_s = _sorted_by_time(t, dtype, dev, y)
    kernel_path = t_s.shape[0] > DENSE_N_MAX
    if kernel_path:
        from gpar_at_scale_torch.ops.grad import logpdf_markov_pallas

    def loglik(p):
        l, sf, sn = unpack_gp(p.T)
        vals = []
        for c in range(p.shape[0]):
            k = time_kernel_only(time_family, l[c], sf[c])
            if kernel_path:
                vals.append(logpdf_markov_pallas(k, t_s, sn[c] ** 2, y_s))
            else:
                vals.append(ssm_logpdf(lgssm_of(k, t_s, sn[c] ** 2, dtype), y_s))
        ll = torch.stack(vals)
        return ll, torch.ones_like(ll, dtype=torch.bool)

    return _logpost(loglik, prior_scale)


def bounded_reparam(logpost: Callable, bound: float = 3.0):
    """Smooth bounded reparameterization of a log posterior over
    log-parameters.

    Sample in unconstrained u-space with p = bound tanh(u / bound) and the
    exact log-Jacobian sum_i log sech^2(u_i / bound); draws constrained back
    to p-space are exact samples from the posterior restricted to
    (-bound, bound)^d.  The float32 likelihoods have a Cholesky cliff at
    extreme log-hyperparameters (long lengthscale, huge signal variance,
    tiny noise: cond(K) > 1 / eps_f32); bounding the effective parameters
    keeps every point the integrator can reach inside float32 range, so
    divergences measure energy error only.  bound = 3 keeps exp(p) in
    [0.05, 20].  Returns (logpost_u, constrain); both take one point or a
    (C, d) batch."""
    b = float(bound)

    def constrain(u):
        return b * torch.tanh(u / b)

    def logpost_u(u):
        x = u / b
        # log sech^2(x) = 2 (log 2 - x - softplus(-2x)), stable for large |x|
        log_jac = (2.0 * (np.log(2.0) - x - torch.nn.functional.softplus(-2.0 * x))).sum(-1)
        return logpost(constrain(u)) + log_jac

    return logpost_u, constrain


class BayesConditionalResult(NamedTuple):
    samples: torch.Tensor  # (C, S, dim) posterior log-parameter draws
    accept_prob: torch.Tensor  # mean over chains and kept transitions
    num_divergent: torch.Tensor  # over all chains
    stats: NUTSResult  # the sampler's per-chain result


def sample_conditional_posterior(
    generator: torch.Generator,
    logpost: Callable,
    *,
    num_chains: int = 4,
    num_samples: int = 500,
    num_warmup: int = 300,
    max_depth: int = 7,
    init_scale: float = 0.3,
    dim: int = 5,
    dtype=torch.float64,
    device=None,
) -> BayesConditionalResult:
    """NUTS chains in lockstep over a conditional's hyperparameters, from
    init_scale N(0, 1) starts drawn from ``generator``; ``logpost`` takes
    the (C, dim) batch."""
    dev = resolve_device(device)
    x0s = init_scale * torch.randn((num_chains, dim), generator=generator, dtype=dtype,
                                   device=generator.device).to(dev)
    res = nuts(generator, value_and_grad(logpost), x0s, num_samples=num_samples,
               num_warmup=num_warmup, max_depth=max_depth)
    return BayesConditionalResult(samples=res.samples, accept_prob=res.accept_prob.mean(),
                                  num_divergent=res.num_divergent.sum(), stats=res)


def predictive_mixture_scaled(
    generator,
    samples,
    t,
    X_prev,
    y,
    Z,
    t_star,
    X_star,
    *,
    time_family=Matern52,
    out_family=Matern52,
    num_theta: int = 16,
    dtype=torch.float64,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior-predictive mixture over hyperparameter draws (scaled
    path): mean = E_theta[mu(theta)], var = E[var] + Var[mu], over
    ``num_theta`` draws evenly spaced through the flattened samples; each
    draw's predictive is the analytic one.  Deterministic: ``generator`` is
    not drawn from (the JAX function's key argument).  q(u) whitens densely
    up to ``DENSE_N_MAX`` steps (K6a under the dense switch) where the JAX
    package runs its sequential filter: the same function."""
    del generator
    dev = resolve_device(device)
    flat = _as(samples, dtype, dev)
    flat = flat.reshape(-1, flat.shape[-1])
    thetas = flat[torch.as_tensor(np.linspace(0, flat.shape[0] - 1, num_theta).astype(np.int64),
                                  device=dev)]
    t_s, X_s, y_s = _sorted_by_time(t, dtype, dev, X_prev, y)
    Z, t_star, X_star = (_as(a, dtype, dev) for a in (Z, t_star, X_star))
    mus, variances = [], []
    for theta in thetas:
        tl, ts, ol, osig, ns = unpack_gpar(theta)
        time_k = time_kernel_only(time_family, tl, ts)
        out_k = out_family(lengthscale=ol, variance=osig**2)
        nv = ns**2
        qu = compute_q_u(out_k, lgssm_of(time_k, t_s, nv, dtype), X_s, Z, y_s, uu_ridge=nv,
                         time_kernel=time_k, t=t_s)
        pred = predict_scaled(out_k, time_k, qu, X_s, t_s, y_s, t_star, X_star, nv, dtype=dtype)
        mus.append(pred.mean)
        variances.append(pred.var)
    mus = torch.stack(mus)
    return mus.mean(0), torch.stack(variances).mean(0) + mus.var(0, correction=0)
