"""Scaled-GPAR pipelines on the small and big synthetic datasets.

Port of ``examples/scaled_examples.py`` (``run`` :24-68, ``main`` :71-76),
which mirrors the reference's ``examples/GPAR_scaled_examples.jl``: y1 by
the temporal GP, y2 and y3 by the scaled DTC conditionals with temporal
structured noise, Adam for 150 steps; M = 10 on the small set and, with
``--big``, M = 50 on the big one (N = 8496).

    python -m gpar_at_scale_torch.examples.scaled_examples [--cpu] [--big]

On the big set every output is above ``DENSE_N_MAX`` steps, so training
runs on the kernels in float32: K1/K2 (output 1's likelihood and the gain
pass), K3 (the whitened columns) and K4a/K4b (the backward); the
predictive smooths with the float64 tensor-code blocked smoother.  The small
set runs dense float64 ``torch.linalg``.
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
from gpar_at_scale_torch.models.gpar import GPARConfig, fit_gpar
from gpar_at_scale_torch.utils.params import pack_gp, pack_gpar

OPT_STEPS = 150


def starts():
    return [pack_gp(0.3, 1.0, 0.1)] + [pack_gpar(0.5, 1.0, 1.0, 1.0, 0.1)] * 2


def run(ds, num_pseudo, max_steps, tag, grid_stride, *, device, plot=True):
    """Fit the chain and predict the grid.  Prints the JAX script's lines;
    returns a dict: the model, grid, means and variances (grid, 3), the
    in-range SMSE per output and the fit and predict seconds."""
    cfg = GPARConfig(backend="scaled", first_output_backend="temporal",
                     num_pseudo_points=num_pseudo, max_opt_steps=max_steps, optimizer="adam")
    synchronize(device)
    t0 = time.time()
    model = fit_gpar(None, ds.x, ds.y_obs, cfg, init_params=starts(), device=device)
    synchronize(device)
    fit_s = time.time() - t0

    grid, truth = ds.x_true[::grid_stride], ds.y_true[::grid_stride]
    in_range = grid <= ds.x.max()
    t0 = time.time()
    means, variances = model.predict(grid)
    means, variances = numpy(means), numpy(variances)
    pred_s = time.time() - t0
    scores = [smse(means[in_range, i], truth[in_range, i]) for i in range(3)]

    print(f"[{tag}] N={len(ds.x)} M={num_pseudo}  fit {fit_s:.1f}s  predict {pred_s:.1f}s")
    for i, s in enumerate(scores):
        print(f"  y{i+1} SMSE (in-range): {s:.4f}")

    plt = get_plt() if plot else None
    if plt:
        fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
        for i, ax in enumerate(axes):
            ax.plot(grid, truth[:, i], "k-", lw=0.8, label="true")
            ax.plot(ds.x, ds.y_obs[:, i], ".", color="gray", ms=1, alpha=0.4, label="obs")
            ax.plot(grid, means[:, i], "C3-", lw=1, label="scaled GPAR")
            sd = np.sqrt(variances[:, i])
            ax.fill_between(grid, means[:, i] - 2 * sd, means[:, i] + 2 * sd, color="C3",
                            alpha=0.15)
            ax.set_ylabel(f"y{i+1}")
        axes[0].legend(ncol=3, fontsize=8)
        fig.savefig(out_path(f"scaled_{tag}.png"), dpi=110, bbox_inches="tight")
        print("saved", out_path(f"scaled_{tag}.png"))
    return dict(model=model, grid=grid, means=means, variances=variances, smse=scores,
                fit_s=fit_s, pred_s=pred_s)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    out = {"small": run(generate_small_dataset(seed=0), num_pseudo=10, max_steps=OPT_STEPS,
                        tag="small", grid_stride=3, device=device)}
    if "--big" in argv:
        out["big"] = run(generate_big_dataset(seed=0), num_pseudo=50, max_steps=OPT_STEPS,
                         tag="big", grid_stride=100, device=device)
    return out


if __name__ == "__main__":
    main()
