"""EEG multi-output prediction: IGP against exact GPAR against scaled GPAR.

Port of ``examples/eeg.py`` (``run`` :34-67, ``run_igp`` :70-86, ``main``
:89-121), which mirrors the reference's ``examples/eeg.jl``: channels F3,
F4, F5, F6 are observed over all 256 points; FZ, F1, F2 over t = 1..156
and predicted for t = 157..256, chained FZ -> F1 -> F2 with the observed
channels (and the predicted means of those before) as inputs.  The
pseudo-points are the training inputs (M = N = 156).  L-BFGS, at most 150
steps per fit, float64 as the JAX script runs.

    python -m gpar_at_scale_torch.examples.eeg [--cpu] [csv]

Reads the CSV at the path given, else the seeded synthetic EEG data
(``data/eeg.py``).  In float64 the dense algebra is ``torch.linalg``; in
float32 with ``engine.pallas_dense = "on"`` (``config.py``) it takes
K6a/K6b/K6c (``chip_smoke.py``'s ``[eeg]`` runs that configuration).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gpar_at_scale_torch.data.eeg import TRAIN_POINTS, load_eeg
from gpar_at_scale_torch.examples._common import (
    device_from_argv,
    get_plt,
    numpy,
    out_path,
    positional,
    smse,
)
from gpar_at_scale_torch.models.gpar import GPARConfig, fit_conditional, fit_first_output
from gpar_at_scale_torch.utils.params import pack_gp, pack_gpar

PREDICTED = ("FZ", "F1", "F2")  # chain order (examples/eeg.jl:212-236)
OBSERVED = ("F3", "F4", "F5", "F6")
OPT_STEPS = 150
GP_START = (0.05, 1.0, 0.3)  # pack_gp: lengthscale, sigma, noise sigma
COND_START = (0.1, 1.0, 1.0, 1.0, 0.3)  # pack_gpar


def _observer(observe):
    return observe if observe is not None else (lambda event, ch, fit: None)


def run(backend: str, ds, *, device, max_opt_steps=OPT_STEPS, dtype=torch.float64, observe=None):
    """Fit the chain with ``backend`` ("exact" or "scaled"); returns
    {channel: (mean, var, fit)} on the 100 test times.  Each conditional
    trains on the true values of the channels before it and predicts from
    their predicted means.  ``observe(event, channel, fit)``, if given, is
    called with "start" before each fit, "fit" after it and "predict" after
    its request (``chip_smoke.py`` reads launch counts and times there)."""
    observe = _observer(observe)
    n_tr = TRAIN_POINTS
    t_tr, t_te = ds.t[:n_tr], ds.t[n_tr:]
    obs_idx = [ds.channels.index(c) for c in OBSERVED]
    as_dev = lambda a: torch.as_tensor(np.asarray(a)).to(device, dtype)  # noqa: E731
    prev_tr = [as_dev(ds.Y[:n_tr, i]) for i in obs_idx]
    prev_te = [as_dev(ds.Y[n_tr:, i]) for i in obs_idx]
    cfg = GPARConfig(backend=backend, num_pseudo_points=n_tr, max_opt_steps=max_opt_steps,
                     dtype=dtype)
    preds = {}
    for ch in PREDICTED:
        yi = ds.channels.index(ch)
        observe("start", ch, None)
        fit = fit_conditional(None, t_tr, torch.stack(prev_tr, 1), ds.Y[:n_tr, yi], cfg,
                              init_params=pack_gpar(*COND_START), device=device)
        observe("fit", ch, fit)
        mu, var = fit.predict(t_te, torch.stack(prev_te, 1))
        observe("predict", ch, fit)
        preds[ch] = (mu, var, fit)
        prev_tr.append(as_dev(ds.Y[:n_tr, yi]))  # train on the true values
        prev_te.append(mu)  # chain the predictions forward
    return preds


def run_igp(ds, *, device, max_opt_steps=OPT_STEPS, dtype=torch.float64, filter_impl="auto",
            observe=None):
    """One temporal GP per predicted channel; returns {channel: (mean,
    var, fit)} on the test times.  ``filter_impl`` as in ``GPARConfig``:
    "auto" takes the sequential filter at this N, a Python loop of 156
    steps per evaluation; "pallas" the scan kernels K1/K2 and K4a/K4b
    (float32).  ``observe`` as in ``run``."""
    observe = _observer(observe)
    n_tr = TRAIN_POINTS
    cfg = GPARConfig(first_output_backend="temporal", filter_impl=filter_impl,
                     max_opt_steps=max_opt_steps, dtype=dtype)
    preds = {}
    for ch in PREDICTED:
        yi = ds.channels.index(ch)
        observe("start", ch, None)
        fit = fit_first_output(None, ds.t[:n_tr], ds.Y[:n_tr, yi], cfg,
                               init_params=pack_gp(*GP_START), device=device)
        observe("fit", ch, fit)
        mu, var = fit.predict(ds.t[n_tr:])
        observe("predict", ch, fit)
        preds[ch] = (mu, var, fit)
    return preds


def smse_table(ds, igp, exact, scaled):
    """{channel: (IGP, GPAR, scaled SMSE)}."""
    n_tr = TRAIN_POINTS
    return {ch: tuple(smse(m[ch][0], ds.Y[n_tr:, ds.channels.index(ch)])
                      for m in (igp, exact, scaled)) for ch in PREDICTED}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    ds = load_eeg(positional(argv), seed=0)
    igp = run_igp(ds, device=device)
    exact = run("exact", ds, device=device)
    scaled = run("scaled", ds, device=device)
    table = smse_table(ds, igp, exact, scaled)
    print("channel |  IGP SMSE | GPAR SMSE | scaled SMSE")
    for ch, (a, b, c) in table.items():
        print(f"  {ch:>4}  | {a:9.4f} | {b:9.4f} | {c:11.4f}")

    plt = get_plt()
    if plt:
        n_tr = TRAIN_POINTS
        fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
        t_te = ds.t[n_tr:]
        for ax, ch in zip(axes, PREDICTED):
            ax.plot(ds.t, ds.Y[:, ds.channels.index(ch)], "k-", lw=0.8, label="true")
            mu, var = numpy(exact[ch][0]), numpy(exact[ch][1])
            ax.plot(t_te, mu, "C3-", label="GPAR exact")
            ax.fill_between(t_te, mu - 2 * np.sqrt(var), mu + 2 * np.sqrt(var), color="C3",
                            alpha=0.2)
            ax.plot(t_te, numpy(scaled[ch][0]), "C0--", label="GPAR scaled")
            ax.axvline(ds.t[n_tr], color="gray", ls=":")
            ax.set_ylabel(ch)
        axes[0].legend(ncol=3, fontsize=8)
        fig.savefig(out_path("eeg.png"), dpi=110, bbox_inches="tight")
        print("saved", out_path("eeg.png"))
    return table


if __name__ == "__main__":
    main()
