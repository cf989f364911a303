"""Exact-GP and temporal-GP regression demos.

Port of ``examples/plot_examples.py`` (``exact_example`` :23-35,
``temporal_example`` :38-52), which mirrors the reference's
``examples/plot_examples.jl``: the exact GP on the small dataset (L-BFGS,
at most 150 steps) and the temporal GP on the big one (N = 8496, Adam, 150
steps).

    python -m gpar_at_scale_torch.examples.plot_examples [--cpu]

The temporal fit's likelihood runs on the kernels K1/K2 forward and K4a/K4b
backward in float32 (above ``DENSE_N_MAX`` steps output 1 takes the kernel
path, ``models/gpar.py::_first_output_nll``; the JAX package runs its
float64 sequential filter there).  Its predictive smooths the spliced
series with the float64 tensor-code blocked smoother (``gp/dtc.py::
smoother_for``).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from gpar_at_scale_torch.data.toy import generate_big_dataset, generate_small_dataset
from gpar_at_scale_torch.examples._common import (
    device_from_argv,
    get_plt,
    numpy,
    out_path,
    smse,
    synchronize,
)
from gpar_at_scale_torch.models.gpar import GPARConfig, fit_first_output
from gpar_at_scale_torch.utils.params import pack_gp

OPT_STEPS = 150


def exact_example(*, device, max_opt_steps=OPT_STEPS, init=None):
    """Returns (dataset, grid, mean, var, fit) and prints the fit's line."""
    ds = generate_small_dataset(seed=0)
    cfg = GPARConfig(first_output_backend="exact", max_opt_steps=max_opt_steps)
    fit = fit_first_output(None, ds.x, ds.y_obs[:, 0], cfg,
                           init_params=pack_gp(0.3, 1.0, 0.1) if init is None else init,
                           device=device)
    grid = ds.x_true[::3]
    mu, var = fit.predict(grid)
    l, sf, sn = fit.hyperparams()
    print(f"[exact] l={l:.3f} sigma_f={sf:.3f} sigma_n={sn:.3f} "
          f"SMSE={smse(mu, ds.y_true[::3, 0]):.4f}")
    return ds, grid, numpy(mu), numpy(var), fit


def temporal_example(*, device, max_opt_steps=OPT_STEPS, init=None):
    """Returns (dataset, grid, mean, var, fit, in-range SMSE) and prints
    the fit's line (fit and predict seconds)."""
    ds = generate_big_dataset(seed=0)
    cfg = GPARConfig(first_output_backend="temporal", max_opt_steps=max_opt_steps,
                     optimizer="adam")
    synchronize(device)
    t0 = time.time()
    fit = fit_first_output(None, ds.x, ds.y_obs[:, 0], cfg,
                           init_params=pack_gp(1.0, 0.5, 1.0) if init is None else init,
                           device=device)
    grid = ds.x_true[::100]
    mu, var = fit.predict(grid)
    mu, var = numpy(mu), numpy(var)
    el = time.time() - t0
    in_range = grid <= ds.x.max()  # x_true extends 50 units past the data
    score = smse(mu[in_range], ds.y_true[::100, 0][in_range])
    print(f"[temporal] N={len(ds.x)} fit+predict {el:.1f}s SMSE(in-range)={score:.4f}")
    return ds, grid, mu, var, fit, score


def plot(e, t):
    plt = get_plt()
    if not plt:
        return
    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    for ax, (ds, grid, mu, var), tag in zip(axes, (e[:4], t[:4]), ("exact small", "temporal big")):
        ax.plot(ds.x_true, ds.y_true[:, 0], "k-", lw=0.8, label="true")
        ax.plot(ds.x, ds.y_obs[:, 0], ".", color="gray", ms=2, alpha=0.5)
        sd = np.sqrt(var)
        ax.plot(grid, mu, "C3-", label=f"{tag} posterior")
        ax.fill_between(grid, mu - 2 * sd, mu + 2 * sd, color="C3", alpha=0.15)
        ax.legend(fontsize=8)
    fig.savefig(out_path("plot_examples.png"), dpi=110, bbox_inches="tight")
    print("saved", out_path("plot_examples.png"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    e = exact_example(device=device)
    t = temporal_example(device=device)
    plot(e, t)
    return e, t


if __name__ == "__main__":
    main()
