"""Tempered SMC over a temporal GP's hyperparameters at N = 1e6 steps, then
the smoothed predictive at the posterior median.

Port of ``benchmarks/million_smc.py``.  Data: its series (:69-76), copied
(numpy seed 0: gaps of 0.5e-3 to 1.5e-3, a sine surrogate f observed with
noise 0.3); a Matern-5/2 GP over (log l, log sigma_f, log sigma_n) with the
N(0, 2^2) prior.  Each particle's likelihood is one call of the kernel path,
K1 then K2 (``ops/kalman.py::decorrelate_blocked``), float32; in float64
it is the tensor-code blocked engine (``ssm/blocked.py::blocked_logpdf``),
the script's own engine.  The times are float32, as the script's (:72).

  default     -- ``inference/smc.py::smc``: the stage loop on the device,
                 every likelihood batch one call per particle;
  ``--host``  -- ``smc_host``: numpy bookkeeping on the host, the
                 likelihoods of ``--chunk`` particles queued on the card and
                 read back together (one host readback per chunk);
  ``--map-init`` (with ``--host``) -- the script's bridge (:21-33): scipy
                 Nelder-Mead to the MAP on the same likelihood, a
                 finite-difference diagonal Laplace scale, then tempering
                 from q0 = N(map, (3 laplace)^2) to prior * lik.

Then the smoothed predictive at the posterior median over all N steps
(``ops/smoother.py::pallas_smooth``: K1/K2, K4a/K4b) and its rmse against
the latent f.  ``--predict-only --median=l,sf,sn`` runs that alone.

    python -m gpar_at_scale_torch.benchmarks.million_smc [N] [--particles=64]
        [--host] [--chunk=1] [--mutations=3] [--map-init]
        [--predict-only --median=l,sf,sn] [--cpu]

The initial particles are 0.5 N(0, 1) from a torch generator seeded 0 (the
script draws them from ``jax.random``); ``smc_host`` draws from
``np.random.default_rng(0)`` in both packages, so on equal likelihood
values the two clouds are equal.  Times in the script's docstring
(16 stages, 1056 evaluations) and ``results_r*/`` are the TPU's.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpar_at_scale_torch.examples._common import (
    device_from_argv,
    device_name,
    int_arg,
    numpy,
    positional,
    synchronize,
)
from gpar_at_scale_torch.ops import launch_counts

TRUTH = (0.7, 1.2, 0.3)  # (l, sigma_f, sigma_n) the script quotes; f is a sine surrogate
MAX_STAGES = 20


def million_smc_data(n):
    """The script's data: (t, y, latent f), numpy float64."""
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(0.5, 1.5, n)) / 1000.0
    f = 1.2 * np.sin(2 * np.pi * t / 7.0) * np.cos(2 * np.pi * t / 1.3)
    return t, f + TRUTH[2] * rng.normal(size=n), f


def matern_lgssm(t, params, dtype=torch.float32):
    """The LGSSM of a Matern-5/2 temporal GP at log-parameters ``params``
    (3,), in ``dtype``."""
    from gpar_at_scale_torch.kernels import Matern52
    from gpar_at_scale_torch.ssm.markov import lgssm_of
    from gpar_at_scale_torch.utils.params import unpack_gp

    l, sf, sn = unpack_gp(params)
    return lgssm_of(Matern52(lengthscale=l, variance=sf**2), t, sn**2, dtype)


def loglik_one(t, y, x, dtype=torch.float32):
    """One particle's log-likelihood as a 0-d tensor on t's device: the
    kernel path (K1, phase 2, K2) in float32, the tensor-code blocked engine
    in float64."""
    from gpar_at_scale_torch.ops.kalman import decorrelate_blocked
    from gpar_at_scale_torch.ssm.blocked import blocked_logpdf

    with torch.no_grad():
        lg = matern_lgssm(t, torch.as_tensor(x, dtype=torch.float64, device=t.device), dtype)
        if dtype == torch.float32:
            return decorrelate_blocked(lg, y)[0]
        return blocked_logpdf(lg, y.to(dtype))


def kernel_loglik(t, y, chunk=1, dtype=torch.float32):
    """``log_lik_batch`` of ``smc_host``: (P, 3) log-parameters -> (P,)
    numpy log-likelihoods, one call per particle, read back every ``chunk``
    particles."""

    def batch(xs):
        xs = np.asarray(xs, np.float64)
        out = []
        for i in range(0, len(xs), chunk):
            lls = [loglik_one(t, y, x, dtype) for x in xs[i:i + chunk]]
            out.append(torch.stack(lls).double().cpu().numpy())
        return np.concatenate(out) if out else np.zeros(0)

    return batch


def log_prior_batch(xs):
    """The N(0, 2^2) prior on the log-parameters, (P,) numpy."""
    return -0.5 * np.sum(np.asarray(xs) ** 2, axis=1) / 4.0


def initial_particles(P, seed=0):
    """(P, 3) numpy: 0.5 N(0, 1) from a torch generator seeded ``seed``."""
    return (0.5 * torch.randn((P, 3), generator=torch.Generator().manual_seed(seed),
                              dtype=torch.float64)).numpy()


def map_bridge(log_lik_batch, P, seed=0):
    """The script's ``--map-init`` (:216-269): Nelder-Mead from 0 to the MAP
    of the likelihood (at most 80 evaluations), the diagonal Laplace scale by
    central differences (h = 0.02), the reference q0 = N(map, (3 s)^2) and
    its draws.  Returns (pmap, s, x0 (P, 3), logq0, bridged log_lik_batch,
    evaluations spent)."""
    from scipy.optimize import minimize

    count = [0]

    def negll(p):
        count[0] += 1
        return -float(log_lik_batch(np.asarray(p, np.float64)[None])[0])

    opt = minimize(negll, np.zeros(3), method="Nelder-Mead",
                   options={"maxfev": 80, "xatol": 1e-3, "fatol": 0.5})
    pmap, h, f0 = opt.x, 0.02, -opt.fun
    s = np.empty(3)
    for i in range(3):
        e = np.zeros(3)
        e[i] = h
        fp, fm = -negll(pmap + e), -negll(pmap - e)
        s[i] = 1.0 / np.sqrt(max((2 * f0 - fp - fm) / h**2, 1e-2))
    q_scale = 3.0 * s
    x0 = pmap[None, :] + q_scale[None, :] * initial_particles(P, seed) / 0.5

    def logq0(xs):
        z = (np.asarray(xs) - pmap[None, :]) / q_scale[None, :]
        return -0.5 * np.sum(z * z, axis=1) - np.log(q_scale).sum() - 1.5 * np.log(2 * np.pi)

    def bridged(xs):
        return log_lik_batch(xs) + log_prior_batch(xs) - logq0(xs)

    return pmap, s, x0, logq0, bridged, count[0]


def smoothed_predictive(t, y, f, med, device):
    """The smoothed mean at the median (l, sf, sn) on the kernels: (rmse vs
    f, seconds)."""
    from gpar_at_scale_torch.ops.smoother import pallas_smooth
    from gpar_at_scale_torch.utils.params import unconstrain

    synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        mean, _, _ = pallas_smooth(matern_lgssm(t, unconstrain(torch.as_tensor(med)).to(device)), y)
    rmse = float(np.sqrt(np.mean((numpy(mean) - f) ** 2)))
    synchronize(device)
    return rmse, time.perf_counter() - t0


def run(N=1_000_000, P=64, *, device, host=False, chunk=1, mutations=3, map_init=False,
        max_stages=MAX_STAGES, seed=0, x0=None, dtype=torch.float32, verbose=True):
    """The script's pipeline on ``device``; prints its lines.  Returns a dict:
    ``result`` (``SMCHostResult`` or ``SMCResult``), ``particles`` (P, 3)
    numpy, ``median`` (l, sf, sn), ``evals``, ``secs``, ``rmse``,
    ``predict_s``, ``launches`` (every kernel's count when the sampler
    ended); with ``map_init`` also ``pmap`` and ``laplace``."""
    from gpar_at_scale_torch.inference.smc import smc, smc_host

    device = torch.device(device)
    t_np, y_np, f = million_smc_data(N)
    t, y = (torch.as_tensor(a).to(device, torch.float32) for a in (t_np, y_np))
    print(f"N={N:,}  particles={P}  device={device_name(device)}", flush=True)
    x0 = initial_particles(P, seed) if x0 is None else np.asarray(x0, np.float64)
    out = {}
    synchronize(device)
    t0 = time.perf_counter()
    if host:
        lik = kernel_loglik(t, y, chunk, dtype)
        prior = log_prior_batch
        if map_init:
            t_map = time.perf_counter()
            pmap, s, x0, prior, lik, extra = map_bridge(lik, P, seed)
            out.update(pmap=pmap, laplace=s)
            print(f"MAP (Nelder-Mead, host-driven, {extra} evals, {time.perf_counter() - t_map:.1f}s): "
                  f"{np.round(pmap, 3)}  laplace scale {np.round(s, 4)}", flush=True)
        res = smc_host(seed, prior, lik, x0, num_mutations=mutations, ess_threshold=0.5,
                       max_stages=max_stages, verbose=verbose)
        if map_init:
            res = res._replace(num_lik_evals=res.num_lik_evals + extra)
        secs = time.perf_counter() - t0
        out["launches"] = launch_counts()
        post, evals = np.asarray(res.particles), res.num_lik_evals
        print(f"SMC host-driven: {secs:.1f}s  stages={res.num_stages}  beta={res.final_beta:.2f}  "
              f"logZ={res.log_evidence:.1f}  accept={res.acceptance:.2f}")
        print(f"{evals} likelihood evals ({evals * N / secs / 1e6:.2f} M filter steps/s "
              f"incl. staging)")
    else:
        calls = [0]

        def lik_batch(xs):
            calls[0] += xs.shape[0]
            return torch.stack([loglik_one(t, y, x, dtype).double().cpu() for x in xs])

        res = smc(torch.Generator().manual_seed(seed),
                  lambda xs: torch.as_tensor(log_prior_batch(xs.numpy())), lik_batch,
                  torch.as_tensor(x0), num_mutations=mutations, ess_threshold=0.5,
                  max_stages=max_stages)
        secs = time.perf_counter() - t0
        out["launches"] = launch_counts()
        post, evals = numpy(res.particles), calls[0]
        print(f"SMC (one program): {secs:.1f}s  stages={res.num_stages}  "
              f"beta={float(res.final_beta):.2f}  logZ={float(res.log_evidence):.1f}")
        print(f"{evals} likelihood evals ({evals * N / secs / 1e9:.3f} B filter steps/s)")
    med = np.exp(np.median(post, axis=0)) + 1e-3
    print(f"posterior median (l, sigma_f, sigma_n): {np.round(med, 3)}  true noise: {TRUTH[2]}")
    rmse, pred_s = smoothed_predictive(t, y, f, med, device)
    print(f"smoothed predictive (all {N:,} pts): rmse vs latent truth {rmse:.4f} "
          f"(noise {TRUTH[2]}) in {pred_s:.1f}s", flush=True)
    out.update(result=res, particles=post, median=med, evals=evals, secs=secs, rmse=rmse,
               predict_s=pred_s)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    n = positional(argv)
    N = int(n) if n else 1_000_000
    if "--predict-only" in argv:
        med_arg = next(a.split("=", 1)[1] for a in argv if a.startswith("--median="))
        t_np, y_np, f = million_smc_data(N)
        t, y = (torch.as_tensor(a).to(device, torch.float32) for a in (t_np, y_np))
        rmse, secs = smoothed_predictive(t, y, f, np.array([float(v) for v in med_arg.split(",")]),
                                         device)
        print(f"smoothed predictive (all {N:,} pts): rmse vs latent truth {rmse:.4f} "
              f"(noise {TRUTH[2]}) in {secs:.1f}s", flush=True)
        return dict(rmse=rmse, predict_s=secs)
    return run(N, int_arg(argv, "particles", 64), device=device, host="--host" in argv,
               chunk=int_arg(argv, "chunk", 1), mutations=int_arg(argv, "mutations", 3),
               map_init="--map-init" in argv)


if __name__ == "__main__":
    main()
