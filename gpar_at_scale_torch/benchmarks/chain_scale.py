"""The P-output GPAR chain at N = 1e6 on one card.

Port of ``benchmarks/chain_scale.py``: output 1 a temporal GP, outputs
2..P scaled DTC conditionals (temporal structured noise, M inducing points
chosen by farthest-point selection, ``examples/_common.py::
farthest_points``), each trained with Adam (learning rate 5e-2) and
predicted with the analytic predictive, the predicted means fed forward
down the chain.  Data: ``data/chain.py`` (the JAX script's
``make_chain_data``, seed 0).

    python -m gpar_at_scale_torch.benchmarks.chain_scale [N] [--outputs=16] [--m=32]
        [--steps=10] [--nstar=10000] [--cpu]

Training and prediction run through the port's engines with
``filter_impl="pallas"``, float32: output 1's likelihood on K1/K2 with
K4a/K4b backward, each conditional's bound on K1/K2 (gain pass) and K3,
its gradient on K4a/K4b; the Gram and the M x M algebra in float64 on the
card (where the JAX script moves them to host float64), q(u) likewise; the
predictive through the float64 M x M inverse factors and the blocked
smoother (``gp/dtc.py``).  Not ported: ``--chunk-cols`` and
``--bwd-chunk``, the TPU column chunking of the filter and of the suffix
scans (ROADMAP "Not to port"), and the per-output ``jit`` column: the port
factors K_uu with the fixed relative jitter of ``utils/psd.py`` and never
escalates it.  Each scaled output prints the JAX script's ``cov2s`` (the
share of test points whose latent error is inside 2 sd of the predictive
*plus the observation noise*, which cannot fail, ROADMAP §3) and beside it
``cov2f``, the same share against the latent band 2 sqrt(var) alone,
which should be near 0.95.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gpar_at_scale_torch.data.chain import make_chain_data
from gpar_at_scale_torch.examples._common import (
    device_from_argv,
    device_name,
    farthest_points,
    int_arg,
    numpy,
    positional,
    timed,
)
from gpar_at_scale_torch.models.gpar import GPARConfig, fit_conditional, fit_first_output
from gpar_at_scale_torch.utils.params import pack_gp, pack_gpar

GP_START = (0.5, 1.0, 0.2)
COND_START = (0.5, 1.0, 1.0, 0.7, 0.2)


def run(N=1_000_000, P=16, M=32, steps=10, n_star=10_000, *, device):
    """Train and predict the chain; prints the JAX script's lines and
    returns a dict: per output ``fits``, ``means`` and ``variances`` (N*,),
    ``rmse``, the scaled outputs' ``cov2s`` and ``cov2f``, ``train_s`` and
    ``pred_s``, and the latent truth ``lat_star`` (N*, P)."""
    f32 = torch.float32
    rng = np.random.default_rng(0)
    t_np, Y_np, ts_np, lat_star, true_sn = make_chain_data(N, n_star, P, rng)
    t, Y, t_star = (torch.as_tensor(a).to(device, f32) for a in (t_np, Y_np, ts_np))
    print(f"N={N:,}  outputs={P}  M={M}  N*={n_star:,}  steps/cond={steps}  "
          f"device={device_name(device)}", flush=True)
    cfg = GPARConfig(backend="scaled", filter_impl="pallas", num_pseudo_points=M, dtype=f32,
                     optimizer="adam", max_opt_steps=steps)

    tr1, fit1 = timed(lambda: fit_first_output(None, t, Y[:, 0], cfg,
                                               init_params=pack_gp(*GP_START), device=device),
                      device)
    pr1, (mu1, var1) = timed(lambda: fit1.predict(t_star), device)
    rmse1 = float(np.sqrt(np.mean((numpy(mu1) - lat_star[:, 0]) ** 2)))
    print(f"[y01 temporal ] train {tr1:7.1f}s ({tr1 / steps * 1e3:7.1f} ms/step)  "
          f"predict {pr1:6.1f}s  rmse {rmse1:.4f}", flush=True)

    fits, means, variances = [fit1], [mu1], [var1]
    rmses, covs, covf, train_s, pred_s = [rmse1], [], [], [tr1], [pr1]
    for i in range(1, P):
        Z = farthest_points(Y_np[:, :i], M, seed=i)
        tr, fit = timed(lambda: fit_conditional(None, t, Y[:, :i], Y[:, i], cfg,
                                                init_params=pack_gpar(*COND_START), Z=Z,
                                                device=device), device)
        pr, (mu, var) = timed(lambda: fit.predict(t_star, torch.stack(means, 1)), device)
        err = np.abs(numpy(mu) - lat_star[:, i])
        v = numpy(var)
        rmse = float(np.sqrt(np.mean(err**2)))
        cov = float(np.mean(err < 2 * np.sqrt(v + true_sn**2)))
        cov_f = float(np.mean(err < 2 * np.sqrt(v)))
        nll = numpy(fit.opt.trace) / N
        fits.append(fit)
        means.append(mu)
        variances.append(var)
        rmses.append(rmse)
        covs.append(cov)
        covf.append(cov_f)
        train_s.append(tr)
        pred_s.append(pr)
        print(f"[y{i + 1:02d} scaled   ] train {tr:7.1f}s ({tr / steps * 1e3:7.1f} ms/step)  "
              f"predict {pr:6.1f}s  nll/N {nll[0]:.4f}->{nll[-1]:.4f}  "
              f"rmse {rmse:.4f}  cov2s {cov:.3f}  cov2f {cov_f:.3f}", flush=True)

    total = sum(train_s) + sum(pred_s)
    steady_train = float(np.median(train_s[1:])) if P > 2 else train_s[-1]
    steady_pred = float(np.median(pred_s[1:])) if P > 2 else pred_s[-1]
    print(f"\nchain[{P} outputs x {N:,} steps]: total {total:8.1f}s  "
          f"(steady-state per conditional: train {steady_train:6.1f}s /"
          f"{steps} steps = {steady_train / steps * 1e3:7.1f} ms/step, "
          f"predict {steady_pred:6.1f}s)", flush=True)
    print(f"rmse per output: {['%.4f' % r for r in rmses]}\n"
          f"2-sigma coverage (scaled outputs): {['%.3f' % c for c in covs]}\n"
          f"2-sigma latent-band coverage (scaled outputs): {['%.3f' % c for c in covf]}\n"
          f"mean rmse {np.mean(rmses):.4f} (obs noise {true_sn}); "
          f"filter work: {(P - 1) * steps * (M + 1) * N / np.sum(train_s[1:]):.2e} "
          f"col-steps/s sustained across conditional training", flush=True)
    return dict(fits=fits, means=means, variances=variances, rmse=rmses, cov2s=covs,
                cov2f=covf, train_s=train_s, pred_s=pred_s, lat_star=lat_star, sn=true_sn)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    n = positional(argv)
    return run(int(n) if n else 1_000_000, P=int_arg(argv, "outputs", 16), M=int_arg(argv, "m", 32),
               steps=int_arg(argv, "steps", 10), n_star=int_arg(argv, "nstar", 10_000),
               device=device)


if __name__ == "__main__":
    main()
