"""Hamiltonian Monte Carlo with dual-averaging step size and diagonal mass
adaptation, over a leading chain axis.

Counterpart of ``gpar_at_scale_tpu/inference/hmc.py``.  The JAX functions
run one chain and are vmapped; here every state carries the chain axis
first: positions ``q (C, dim)``, a step size and a dual-averaging state per
chain ``(C,)``, a diagonal inverse mass per chain ``(C, dim)``.  The helpers
(``da_*``, ``welford_*``, ``leapfrog``) broadcast over any leading axes, so
they also take one chain as the JAX ones do.

The log density enters as ``logprob_and_grad(q (C, dim)) -> (lp (C,),
g (C, dim))``; ``value_and_grad`` builds that from a log density by
autograd.  HMC has no data-dependent control flow: its loops run on the
host with no readback.  Every draw comes from the ``torch.Generator``
passed in, on the generator's device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


def _randn(generator: torch.Generator, shape, like):
    """Standard normals of ``like``'s dtype from ``generator``, drawn on the
    generator's device and moved to ``like``'s."""
    x = torch.randn(shape, generator=generator, dtype=like.dtype, device=generator.device)
    return x.to(like.device)


def _rand(generator: torch.Generator, shape, like):
    """U(0, 1) draws, as ``_randn``."""
    x = torch.rand(shape, generator=generator, dtype=like.dtype, device=generator.device)
    return x.to(like.device)


def value_and_grad(logprob: Callable, batched: bool = True) -> Callable:
    """The samplers' contract ``q (C, dim) -> (lp (C,), g (C, dim))`` from a
    log density, by autograd (a batched ``logprob`` also takes one (dim,)
    point).

    batched: ``logprob`` takes the whole (C, dim) batch and returns (C,),
    each chain's value depending on its own row only (the Bayesian
    logposts of ``models/bayes.py``); otherwise ``logprob`` takes one
    (dim,) point and is called once per chain.  A chain whose lp is not
    finite (a factorization that failed, an overflow) gets a zero gradient:
    the samplers treat such a point as divergent and never step from it."""

    def fn(q):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            lp = logprob(x) if batched else torch.stack([logprob(xi) for xi in x])
            (g,) = torch.autograd.grad(lp.sum(), x)
        lp = lp.detach()
        return lp, torch.where(torch.isfinite(lp)[..., None], g, torch.zeros_like(g))

    return fn


class DAState(NamedTuple):
    """Nesterov dual-averaging state of the log step size (Hoffman and
    Gelman 2014, Algorithm 5), one entry per chain."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    step: torch.Tensor


def da_init(eps0) -> DAState:
    log_eps = torch.log(torch.as_tensor(eps0))
    return DAState(
        log_eps=log_eps,
        log_eps_avg=torch.zeros_like(log_eps),
        h_avg=torch.zeros_like(log_eps),
        mu=math.log(10.0) + log_eps,
        step=torch.zeros_like(log_eps, dtype=torch.int32),
    )


def da_update(state: DAState, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75) -> DAState:
    step = state.step + 1
    n = step.to(state.h_avg.dtype)
    eta_h = 1.0 / (n + t0)
    h_avg = (1.0 - eta_h) * state.h_avg + eta_h * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(n) / gamma * h_avg
    eta = n ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DAState(log_eps=log_eps, log_eps_avg=log_eps_avg, h_avg=h_avg, mu=state.mu, step=step)


class WelfordState(NamedTuple):
    """Streaming mean and variance for the diagonal mass: mean, m2
    (..., dim), count (...)."""

    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor


def welford_init(dim, dtype=torch.float64, batch=(), device=None) -> WelfordState:
    z = torch.zeros(tuple(batch) + (dim,), dtype=dtype, device=device)
    return WelfordState(mean=z, m2=z.clone(), count=torch.zeros(tuple(batch), dtype=dtype, device=device))


def welford_update(state: WelfordState, x) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean=mean, m2=m2, count=count)


def welford_variance(state: WelfordState, regularize: bool = True):
    n = state.count[..., None]
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:  # Stan's shrink toward 1e-3
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def _per_chain(x, q):
    """A scalar or per-chain (...,) value shaped to broadcast against q
    (..., dim)."""
    x = torch.as_tensor(x, dtype=q.dtype, device=q.device)
    return x.reshape(x.shape + (1,) * (q.ndim - x.ndim))


def leapfrog(logprob_grad_fn: Callable, q, p, eps, inv_mass, num_steps):
    """``num_steps`` leapfrog steps with diagonal mass; eps scalar or per
    chain.  Returns (q, p, logprob, grad)."""
    e = _per_chain(eps, q)
    lp, g = logprob_grad_fn(q)
    for _ in range(num_steps):
        p_half = p + 0.5 * e * g
        q = q + e * inv_mass * p_half
        lp, g = logprob_grad_fn(q)
        p = p_half + 0.5 * e * g
    return q, p, lp, g


def _kinetic(p, inv_mass):
    return 0.5 * (p * p * inv_mass).sum(-1)


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (C, num_samples, dim)
    log_probs: torch.Tensor  # (C, num_samples)
    accept_prob: torch.Tensor  # (C,) mean acceptance over the kept samples
    step_size: torch.Tensor  # (C,) adapted step size
    inv_mass: torch.Tensor  # (C, dim) adapted diagonal inverse mass
    num_divergent: torch.Tensor  # (C,)


def _chains(x0):
    """x0 (C, dim) or one chain (dim,) -> ((C, dim), squeeze)."""
    x0 = torch.as_tensor(x0)
    return (x0[None], True) if x0.ndim == 1 else (x0, False)


def hmc(
    generator: torch.Generator,
    logprob_and_grad: Callable,
    x0,
    *,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
) -> HMCResult:
    """Adaptive HMC over C chains in lockstep from x0 (C, dim).  Warmup
    adapts each chain's step size (dual averaging) and diagonal mass
    (Welford); sampling runs with both frozen.  A one-chain x0 (dim,) gives
    results without the chain axis, as the JAX function's."""
    q, squeeze = _chains(x0)
    C, dim = q.shape
    dtype, dev = q.dtype, q.device

    def one_step(q, lp, g, eps, inv_mass):
        p = _randn(generator, (C, dim), q) / torch.sqrt(inv_mass)
        q_new, p_new, lp_new, g_new = leapfrog(logprob_and_grad, q, p, eps, inv_mass, num_leapfrog)
        delta = (-lp + _kinetic(p, inv_mass)) - (-lp_new + _kinetic(p_new, inv_mass))
        divergent = torch.isnan(delta) | (delta < -1000.0)
        accept_prob = torch.where(divergent, 0.0, torch.exp(torch.clamp(delta, max=0.0)))
        accept = _rand(generator, (C,), q) < accept_prob
        q = torch.where(accept[:, None], q_new, q)
        lp = torch.where(accept, lp_new, lp)
        g = torch.where(accept[:, None], g_new, g)
        return q, lp, g, accept_prob, divergent

    lp, g = logprob_and_grad(q)
    da = da_init(torch.full((C,), initial_step_size, dtype=dtype, device=dev))
    wf = welford_init(dim, dtype, (C,), dev)
    ones = torch.ones((C, dim), dtype=dtype, device=dev)
    for _ in range(num_warmup):
        inv_mass = welford_variance(wf) if adapt_mass else ones
        q, lp, g, aprob, _ = one_step(q, lp, g, torch.exp(da.log_eps), inv_mass)
        da = da_update(da, aprob, target=target_accept)
        if adapt_mass:
            wf = welford_update(wf, q)

    eps = torch.exp(da.log_eps_avg)
    inv_mass = welford_variance(wf) if adapt_mass else ones
    qs = q.new_empty((C, num_samples, dim))
    lps, aprobs = q.new_empty((C, num_samples)), q.new_empty((C, num_samples))
    divs = torch.zeros(C, dtype=torch.int64, device=dev)
    for s in range(num_samples):
        q, lp, g, aprobs[:, s], div = one_step(q, lp, g, eps, inv_mass)
        qs[:, s], lps[:, s] = q, lp
        divs += div
    out = HMCResult(samples=qs, log_probs=lps, accept_prob=aprobs.mean(1), step_size=eps,
                    inv_mass=inv_mass, num_divergent=divs)
    return HMCResult(*(x[0] for x in out)) if squeeze else out


def effective_sample_size(samples: torch.Tensor) -> torch.Tensor:
    """Per-dimension ESS of one chain by Geyer's initial monotone positive
    sequence: samples (..., n, dim) -> (..., dim), leading axes (chains)
    each on their own."""
    x = samples - samples.mean(-2, keepdim=True)
    n = x.shape[-2]
    nfft = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(x, n=nfft, dim=-2)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-2)[..., :n, :] / n
    acorr = acov / acov[..., :1, :]
    m = n // 2
    gamma = acorr[..., 0 : 2 * m : 2, :] + acorr[..., 1 : 2 * m : 2, :]
    # initial positive sequence, then made monotone nonincreasing
    positive = (torch.cumprod((gamma > 0).to(torch.int32), dim=-2) > 0)
    gamma = torch.where(positive, gamma, torch.zeros_like(gamma))
    gamma = torch.cummin(gamma, dim=-2).values
    tau = -1.0 + 2.0 * gamma.sum(-2)
    return n / torch.clamp(tau, min=1.0)
