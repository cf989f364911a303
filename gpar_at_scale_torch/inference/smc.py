"""Sequential Monte Carlo sampler over hyperparameters.

Counterpart of ``gpar_at_scale_tpu/inference/smc.py``: adaptive-tempering
SMC (prior -> posterior annealing) with systematic resampling and
random-walk Metropolis mutations whose proposal scale comes from the
current particle cloud, with a log-evidence estimate as a by-product.

``smc`` keeps its state on the device as tensors and evaluates
``log_lik_fn`` on the whole (P, dim) particle batch; the next inverse
temperature is found by a fixed 30-step bisection on the ESS criterion on
the device, and the stage loop reads beta back once per stage.
``smc_host`` runs the same algorithm with numpy bookkeeping around a
caller-supplied batch likelihood (the JAX package's host-driven staging),
which is how a million-step likelihood is sampled one particle per call.
"""

from __future__ import annotations

import math
import sys
import time as _time
from typing import Callable, NamedTuple

import numpy as np
import torch

from gpar_at_scale_torch.inference.hmc import _rand, _randn


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (P, dim) final (posterior) particles
    log_evidence: torch.Tensor  # log Z estimate
    num_stages: int
    final_beta: torch.Tensor
    acceptance: torch.Tensor  # mean mutation acceptance at the final stage


def _systematic_resample(generator, log_weights, n):
    """Indices of n systematic draws from softmax(log_weights), clamped to
    n - 1 (the JAX gather clamps an index past the end the same way)."""
    cum = torch.cumsum(torch.softmax(log_weights, 0), 0)
    u0 = _rand(generator, (), log_weights)
    points = (u0 + torch.arange(n, dtype=cum.dtype, device=cum.device)) / n
    return torch.clamp(torch.searchsorted(cum, points), max=n - 1)


def _ess(log_w):
    lw = log_w - torch.logsumexp(log_w, -1, keepdim=True)
    return torch.exp(-torch.logsumexp(2.0 * lw, -1))


def smc(
    generator: torch.Generator,
    log_prior_fn: Callable,
    log_lik_fn: Callable,
    x0,
    *,
    ess_threshold: float = 0.5,
    num_mutations: int = 5,
    max_stages: int = 50,
    rw_scale: float = 0.5,
) -> SMCResult:
    """Adaptive tempered SMC from the prior sample ``x0`` (P, dim);
    ``log_prior_fn`` and ``log_lik_fn`` map (P, dim) -> (P,).

    At stage s with inverse temperature beta_s the incremental weights are
    (beta_{s+1} - beta_s) * log_lik; beta_{s+1} is the largest temperature
    keeping ESS >= ess_threshold * P (bisection).  After reweighting:
    systematic resampling and ``num_mutations`` random-walk Metropolis
    steps targeting prior * lik^beta with proposal sd = rw_scale * the
    particles' sd."""
    particles = torch.as_tensor(x0)
    P, dim = particles.shape
    dtype = particles.dtype
    target = ess_threshold * P

    def next_beta(beta, loglik):
        """Largest b in (beta, 1] with ESS((b - beta) loglik) >= target."""
        lo, hi = beta, torch.ones_like(beta)
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            ok = _ess((mid - beta) * loglik) >= target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        return torch.where(_ess((1.0 - beta) * loglik) >= target, torch.ones_like(beta), lo)

    def mutate(particles, beta):
        std = particles.std(0, correction=0) + 1e-6

        def target_lp(x):
            return log_prior_fn(x) + beta * log_lik_fn(x)

        xs, lps = particles, target_lp(particles)
        accs = []
        for _ in range(num_mutations):
            prop = xs + rw_scale * std[None, :] * _randn(generator, xs.shape, xs)
            lps_prop = target_lp(prop)
            accept = torch.log(_rand(generator, (P,), xs)) < lps_prop - lps
            xs = torch.where(accept[:, None], prop, xs)
            lps = torch.where(accept, lps_prop, lps)
            accs.append(accept.to(dtype).mean())
        return xs, torch.stack(accs).mean()

    beta = particles.new_zeros(())
    logZ = particles.new_zeros(())
    acc = particles.new_zeros(())
    stage = 0
    while stage < max_stages and float(beta) < 1.0:  # one readback per stage
        loglik = log_lik_fn(particles)
        beta_new = next_beta(beta, loglik)
        inc = (beta_new - beta) * loglik
        logZ = logZ + torch.logsumexp(inc, 0) - math.log(P)
        particles = particles[_systematic_resample(generator, inc, P)]
        particles, acc = mutate(particles, beta_new)
        beta = beta_new
        stage += 1
    return SMCResult(particles=particles, log_evidence=logZ, num_stages=stage,
                     final_beta=beta, acceptance=acc)


class SMCHostResult(NamedTuple):
    particles: np.ndarray  # (P, dim) posterior particles
    log_evidence: float
    num_stages: int
    final_beta: float
    acceptance: float
    num_lik_evals: int


def smc_host(
    seed: int,
    log_prior_batch: Callable,
    log_lik_batch: Callable,
    x0,
    *,
    ess_threshold: float = 0.5,
    num_mutations: int = 3,
    max_stages: int = 20,
    rw_scale: float = 0.5,
    verbose: bool = False,
) -> SMCHostResult:
    """Host-driven adaptive tempered SMC: the algorithm of ``smc``
    (adaptive beta by ESS bisection, systematic resampling, random-walk
    mutations) with the stage loop, resampling and accept/reject
    bookkeeping in numpy on the host, draws from ``np.random.default_rng(
    seed)``.  The expensive part, the likelihood of a particle batch, goes
    through the caller's ``log_lik_batch(particles (P, dim)) -> (P,)``,
    which may evaluate one particle per call on the card (a million-step
    Kalman likelihood per particle).  The bookkeeping is O(P dim) per
    stage.  Resampling indices are clamped to P - 1, where the cumulative
    weights' rounding leaves the last point past their end."""
    t_start = _time.time()

    def _log(msg):
        if verbose:
            print(f"[smc_host +{_time.time()-t_start:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    def logsumexp(a):
        a = np.asarray(a, np.float64)
        m = a.max()
        return float(m + np.log(np.exp(a - m).sum()))

    rng = np.random.default_rng(seed)
    x = np.array(x0, np.float64, copy=True)
    P, dim = x.shape
    _log(f"initial likelihood batch: {P} evals...")
    loglik = np.asarray(log_lik_batch(x), np.float64)
    n_evals = P
    _log(f"initial batch done ({(_time.time()-t_start)/P:.2f} s/eval incl. compile)")
    beta, logZ, stage, acc = 0.0, 0.0, 0, 0.0

    def ess_of(lw):
        lw = lw - logsumexp(lw)
        return float(np.exp(-logsumexp(2.0 * lw)))

    while beta < 1.0 and stage < max_stages:
        target = ess_threshold * P
        if ess_of((1.0 - beta) * loglik) >= target:
            beta_new = 1.0
        else:
            lo, hi = beta, 1.0
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if ess_of((mid - beta) * loglik) >= target:
                    lo = mid
                else:
                    hi = mid
            beta_new = lo
        inc = (beta_new - beta) * loglik
        logZ += logsumexp(inc) - np.log(P)

        # systematic resample on the incremental weights
        w = np.exp(inc - logsumexp(inc))
        cum = np.cumsum(w)
        pts = (rng.uniform() + np.arange(P)) / P
        idx = np.minimum(np.searchsorted(cum, pts), P - 1)
        x, loglik = x[idx], loglik[idx]

        std = x.std(axis=0) + 1e-6
        lp = np.asarray(log_prior_batch(x), np.float64) + beta_new * loglik
        accs = []
        for _ in range(num_mutations):
            prop = x + rw_scale * std[None, :] * rng.normal(size=x.shape)
            ll_prop = np.asarray(log_lik_batch(prop), np.float64)
            n_evals += P
            lp_prop = np.asarray(log_prior_batch(prop), np.float64) + beta_new * ll_prop
            a = np.log(rng.uniform(size=P)) < lp_prop - lp
            x[a], loglik[a], lp[a] = prop[a], ll_prop[a], lp_prop[a]
            accs.append(float(a.mean()))
        acc = float(np.mean(accs))
        beta = beta_new
        stage += 1
        _log(
            f"stage {stage}: beta={beta:.4f}  logZ={logZ:.2f}  "
            f"accept={acc:.2f}  evals={n_evals}"
        )

    return SMCHostResult(
        particles=x,
        log_evidence=float(logZ),
        num_stages=stage,
        final_beta=float(beta),
        acceptance=acc,
        num_lik_evals=n_evals,
    )
