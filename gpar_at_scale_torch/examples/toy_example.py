"""Independent GPs against GPAR on the small synthetic chained dataset.

Port of ``examples/toy_example.py`` (``main``, :22-76), which mirrors the
reference's ``GPAR_examples/toy_example.jl``: one exact GP per output on
time, and the exact GPAR chain, each trained by L-BFGS (at most 150 steps)
and predicted on a grid of about 300 points, SMSE against the true curves.

    python -m gpar_at_scale_torch.examples.toy_example [--cpu]

float64 dense algebra (``torch.linalg``): no hand-written kernel runs.
"""

from __future__ import annotations

import sys

from gpar_at_scale_torch.data.toy import generate_small_dataset
from gpar_at_scale_torch.examples._common import device_from_argv, get_plt, numpy, out_path, smse
from gpar_at_scale_torch.models.gpar import GPARConfig, fit_first_output, fit_gpar
from gpar_at_scale_torch.utils.params import pack_gp, pack_gpar

OPT_STEPS = 150


def igp_starts():
    return [pack_gp(0.3, 1.0, 0.1)] * 3


def gpar_starts():
    return [pack_gp(0.3, 1.0, 0.1)] + [pack_gpar(0.5, 1.0, 1.0, 1.0, 0.1)] * 2


def run(*, device, max_opt_steps=OPT_STEPS, igp_inits=None, gpar_inits=None):
    """Fit and predict both models.  Returns a dict: the grid, the truth on
    it, ``igp`` [(fit, mean, var)] per output, ``model`` (the GPAR chain),
    its ``means`` and ``variances`` (grid, 3) and ``smse`` [(IGP, GPAR)]
    per output."""
    ds = generate_small_dataset(seed=0)
    stride = len(ds.x_true) // 300
    grid, truth = ds.x_true[::stride], ds.y_true[::stride]
    cfg = GPARConfig(first_output_backend="exact", max_opt_steps=max_opt_steps)
    igp = []
    for i, p0 in enumerate(igp_inits or igp_starts()):
        fit = fit_first_output(None, ds.x, ds.y_obs[:, i], cfg, init_params=p0, device=device)
        mu, var = fit.predict(grid)
        igp.append((fit, mu, var))
    gcfg = GPARConfig(backend="exact", first_output_backend="exact", max_opt_steps=max_opt_steps)
    model = fit_gpar(None, ds.x, ds.y_obs, gcfg, init_params=gpar_inits or gpar_starts(),
                     device=device)
    means, variances = model.predict(grid)
    rows = [(smse(igp[i][1], truth[:, i]), smse(means[:, i], truth[:, i])) for i in range(3)]
    return dict(ds=ds, grid=grid, truth=truth, igp=igp, model=model, means=means,
                variances=variances, smse=rows)


def report(res):
    print("output |   IGP SMSE | GPAR SMSE")
    for i, (a, b) in enumerate(res["smse"]):
        print(f"   y{i+1}  | {a:10.4f} | {b:9.4f}")


def plot(res):
    plt = get_plt()
    if not plt:
        return
    ds, grid, truth = res["ds"], res["grid"], res["truth"]
    means = numpy(res["means"])
    fig, axes = plt.subplots(3, 1, figsize=(9, 9), sharex=True)
    for i, ax in enumerate(axes):
        ax.plot(grid, truth[:, i], "k-", lw=1, label="true")
        ax.plot(ds.x, ds.y_obs[:, i], "k.", ms=4, label="obs")
        ax.plot(grid, numpy(res["igp"][i][1]), "C0--", label="IGP")
        ax.plot(grid, means[:, i], "C3-", label="GPAR")
        ax.set_ylabel(f"y{i+1}")
        if i == 0:
            ax.legend(ncol=4, fontsize=8)
    fig.savefig(out_path("toy_example.png"), dpi=110, bbox_inches="tight")
    print("saved", out_path("toy_example.png"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    res = run(device=device_from_argv(argv))
    report(res)
    plot(res)
    return res


if __name__ == "__main__":
    main()
