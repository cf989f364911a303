"""DTC validation: the Kalman-whitened DTC bound against a dense Cholesky
reference, and the exact against the scaled optimum.

Port of ``examples/dtc_example.py`` (``compare_dtc_with_dense`` :26-63,
``compare_optimum_params`` :66-82), which mirrors the reference's
``examples/dtc_example.jl``.

    python -m gpar_at_scale_torch.examples.dtc_example [--cpu]

Part (a) whitens through the sequential Kalman filter, as the JAX script's
``dtc_objective`` does when it is given no ``filter_fn``; ``chip_smoke.py``
also runs it in float32 with ``filter_fn="pallas"`` (K1/K2/K3).  Its dense
side factors K_uu with the ridge the bound adds (``uu_ridge="auto"``, the
observation noise s2, the reference's noisy u, ``src/gp/dtc.jl:35``).  The
JAX script's dense side adds 1e-10 instead, so its two numbers are two
functions and its assertion (``diff < 1e-5 |dense|``, :63) fails there:
16.239745 against 15.723955 (``dense_dtc(uu_ridge=1e-10)`` gives that
number here too).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gpar_at_scale_torch.data.toy import generate_small_dataset
from gpar_at_scale_torch.examples._common import device_from_argv
from gpar_at_scale_torch.gp.dtc import dtc_objective
from gpar_at_scale_torch.kernels import Matern52
from gpar_at_scale_torch.models.gpar import GPARConfig, fit_conditional
from gpar_at_scale_torch.ssm.markov import lgssm_of
from gpar_at_scale_torch.utils.params import pack_gpar

OUT_K = (1.0, 0.8)  # (lengthscale, variance) of the output kernel
TIME_K = (0.5, 1.2)  # of the time kernel
NOISE_VAR = 0.1**2
OPT_STEPS = 200
PARAM_NAMES = ("time_l", "time_sigma", "out_l", "out_sigma", "noise_sigma")


def _problem(num_pseudo):
    """(t, V, y, Z) of the small dataset as float64 numpy arrays, Z the
    JAX script's evenly strided rows of V."""
    ds = generate_small_dataset(seed=0)
    V = ds.y_obs[:, :1]
    return ds.x, V, ds.y_obs[:, 1], V[np.linspace(0, len(ds.x) - 1, num_pseudo).astype(int)]


def dense_dtc(num_pseudo=10, uu_ridge=NOISE_VAR):
    """The DTC bound by dense float64 numpy algebra: chol of the full
    temporal covariance, K_uu + ``uu_ridge`` I factored (the JAX script
    adds 1e-10)."""
    t, V, y, Z = _problem(num_pseudo)
    f64 = torch.float64
    tt = torch.as_tensor(t, dtype=f64)[:, None]
    time_k = Matern52(lengthscale=torch.tensor(TIME_K[0], dtype=f64),
                      variance=torch.tensor(TIME_K[1], dtype=f64))
    out_k = Matern52(lengthscale=torch.tensor(OUT_K[0], dtype=f64),
                     variance=torch.tensor(OUT_K[1], dtype=f64))
    Vt, Zt = torch.as_tensor(V, dtype=f64), torch.as_tensor(Z, dtype=f64)
    n = len(t)
    Sigma = time_k(tt, tt).numpy() + NOISE_VAR * np.eye(n)
    Ly = np.linalg.cholesky(Sigma)
    alpha = np.linalg.solve(Ly, y)
    beta = np.linalg.solve(Ly, out_k(Vt, Zt).numpy())
    Lu = np.linalg.cholesky(out_k(Zt, Zt).numpy() + uu_ridge * np.eye(num_pseudo))
    A = np.linalg.solve(Lu, beta.T)
    Lam = A @ A.T + np.eye(num_pseudo)
    w = np.linalg.solve(np.linalg.cholesky(Lam), A @ alpha)
    return float(-0.5 * (n * np.log(2 * np.pi) + np.linalg.slogdet(Sigma)[1]
                         + np.linalg.slogdet(Lam)[1] + alpha @ alpha - w @ w))


def kalman_dtc(num_pseudo=10, *, device, dtype=torch.float64, filter_fn=None):
    """The bound by ``gp.dtc.dtc_objective`` through the Kalman whitening:
    the sequential filter (``filter_fn=None``, as the JAX script) or the
    kernels (``"pallas"``, float32)."""
    t, V, y, Z = (torch.as_tensor(a).to(device, dtype) for a in _problem(num_pseudo))
    out_k = Matern52(lengthscale=torch.tensor(OUT_K[0], dtype=dtype, device=device),
                     variance=torch.tensor(OUT_K[1], dtype=dtype, device=device))
    time_k = Matern52(lengthscale=torch.tensor(TIME_K[0], dtype=dtype, device=device),
                      variance=torch.tensor(TIME_K[1], dtype=dtype, device=device))
    with torch.no_grad():
        lgssm = lgssm_of(time_k, t, NOISE_VAR, dtype)
        return float(dtc_objective(out_k, lgssm, V, Z, y, filter_fn=filter_fn))


def compare_dtc_with_dense(num_pseudo=10, *, device, dtype=torch.float64, filter_fn=None,
                           check=True):
    """(a): the two computations of the bound.  Prints the JAX script's
    three lines and, with ``check``, asserts its bound on the difference.
    Returns (kalman, dense, difference)."""
    k = kalman_dtc(num_pseudo, device=device, dtype=dtype, filter_fn=filter_fn)
    d = dense_dtc(num_pseudo)
    diff = abs(k - d)
    print(f"DTC (Kalman-whitened): {k:.6f}")
    print(f"DTC (dense Cholesky):  {d:.6f}")
    print(f"difference:            {diff:.2e}")
    if check:
        assert diff < 1e-5 * abs(d), "DTC implementations disagree"
    return k, d, diff


def compare_optimum_params(*, device, max_opt_steps=OPT_STEPS, init=None):
    """(b): exact and scaled optima from the same start with the
    pseudo-points the inputs (L-BFGS).  Prints the table and returns
    (exact fit, scaled fit)."""
    ds = generate_small_dataset(seed=0)
    init = pack_gpar(0.5, 1.0, 1.0, 1.0, 0.1) if init is None else init
    cfg_e = GPARConfig(backend="exact", max_opt_steps=max_opt_steps)
    cfg_s = GPARConfig(backend="scaled", num_pseudo_points=len(ds.x), max_opt_steps=max_opt_steps)
    args = (None, ds.x, ds.y_obs[:, :1], ds.y_obs[:, 1])
    fe = fit_conditional(*args, cfg_e, init_params=init, device=device)
    fs = fit_conditional(*args, cfg_s, init_params=init, device=device)
    print(f"{'param':>12} | {'exact':>8} | {'scaled':>8}")
    for n_, e, s in zip(PARAM_NAMES, fe.hyperparams(), fs.hyperparams()):
        print(f"{n_:>12} | {e:8.3f} | {s:8.3f}")
    return fe, fs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    compare_dtc_with_dense(device=device)
    print()
    compare_optimum_params(device=device)


if __name__ == "__main__":
    main()
