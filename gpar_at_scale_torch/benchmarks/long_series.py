"""The Kalman whitening engines side by side on one long series (N = 1e6).

Port of ``benchmarks/long_series.py``.  Data: its series (:68-71), copied
(numpy seed 0: gaps of 0.5e-3 to 1.5e-3, y = sin(3 t) + 0.3 noise), a
Matern-5/2 GP (lengthscale 1, variance 1) with noise 0.09.  Rows, each the
script's, on the port's counterpart:

  filter        -- ``ssm/blocked.py::blocked_decorrelate`` (tensor code);
  smooth        -- ``ssm/blocked.py::blocked_smooth``;
  smooth-split  -- ``blocked_filter``, then ``blocked_smooth`` given it;
  segfilter     -- ``ssm/segmented.py::segmented_decorrelate_t``;
  segsmooth     -- ``ssm/segmented.py::segmented_smooth_t``;
  ffbs          -- ``blocked_posterior_sample``'s two stages: the filter
                   with moments on K1/K2, the sampling pass on K4a/K4b with
                   C = ``--samples`` (``ops/smoother.py::draw_states``);
  segsample     -- ``ssm/segmented.py::segmented_posterior_sample``;
  seq           -- ``ssm/kalman.py::decorrelate``, the sequential filter
                   (a Python loop of N steps: give it a small N);
  assoc         -- ``ssm/pkalman.py::parallel_decorrelate``;
  ``--pallas``  -- ``ops/kalman.py::decorrelate_blocked`` (K1/K2) and
                   ``ops/smoother.py::pallas_smooth`` (K1/K2, K4a/K4b).

    python -m gpar_at_scale_torch.benchmarks.long_series [N] [--no-seq]
        [--assoc] [--pallas] [--blocks=B] [--reps=R] [--segment=S]
        [--samples=S] [--only=ROW] [--cpu]

The rows run in the script's order and choice: filter and smooth unless
``--only`` names another row, that row, the kernel rows with ``--pallas``,
seq (without ``--only`` unless ``--no-seq``), assoc with ``--assoc``.  Each row prints
the script's line: its first call's seconds (the kernels load there; the
script's compile), the time of one call (the mean of ``--reps`` timed calls
after the first, by CUDA events on the card and the host clock on the
CPU) with its steps per second, and ``ll``, the sum of the row's first
output (the log-likelihood; for the smoothers the sum of the smoothed
means, as the script sums its first output).  float32, the times in
float64 (``ssm/markov.py::lgssm_of`` discretizes from them).  Not ported:
``--chunk`` (``pallas_decorrelate_chunked``), the TPU's column chunking of
the kernel filter.  The script's repetition inside one jit (:89-93) and its
input nudges against the TPU service's memo are not needed: each call is
timed as it is made.  Times in its docstring and ``results_r*/`` are the
TPU's.
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
    positional,
    synchronize,
)

NOISE = 0.09
ROWS = ("filter", "smooth", "smooth-split", "segfilter", "segsmooth", "ffbs", "segsample", "seq",
        "assoc", "pallas filter", "pallas smooth")


def series(N, seed=0):
    """The script's series: (t, y) numpy float64."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 1.5, N)) / 1000.0
    return t, np.sin(t * 3) + 0.3 * rng.normal(size=N)


def kernel(device):
    from gpar_at_scale_torch.kernels import Matern52

    one = torch.tensor(1.0, dtype=torch.float64, device=device)
    return Matern52(lengthscale=one, variance=one)


def time_call(fn, reps, device):
    """(seconds of the first call, mean seconds of ``reps`` calls after it,
    the last output): CUDA events on the card, the host clock else."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    first = time.perf_counter() - t0
    reps = max(1, int(reps))
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return first, start.elapsed_time(end) / 1e3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return first, (time.perf_counter() - t0) / reps, out


def row_fns(t, y, lg, *, num_blocks=None, segment=None, samples=4, seed=0):
    """{row: a function of no arguments computing it}; each returns a tuple
    whose first entry the script sums into its ``ll``."""
    from gpar_at_scale_torch.ops.kalman import decorrelate_blocked
    from gpar_at_scale_torch.ops.smoother import draw_states, pallas_smooth
    from gpar_at_scale_torch.ssm import blocked, kalman, pkalman, segmented
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    k = kernel(t.device)
    seg = segmented.SEGMENT_SIZE if segment is None else segment
    gen = torch.Generator(device=t.device).manual_seed(seed)
    d = lg.dim

    def smooth():
        sm = blocked.blocked_smooth(lg, y, num_blocks=num_blocks)
        return sm.mean, sm.var

    def smooth_split():
        fr = blocked.blocked_filter(lg, y[:, None], num_blocks)
        sm = blocked.blocked_smooth(lg, y[:, None], filter_result=fr, num_blocks=num_blocks)
        return sm.mean[:, 0], sm.var

    def segsmooth():
        sm = segmented.segmented_smooth_t(k, t, NOISE, y, seg, num_blocks=num_blocks,
                                          dtype=y.dtype)
        return sm.mean, sm.var

    def ffbs():
        _, _, _, m, P = decorrelate_blocked(lg, y, return_moments=True)
        xi = torch.randn((y.shape[0], d, samples), generator=gen, dtype=y.dtype, device=y.device)
        return (draw_states(lg, m, P, xi)[:, 0, :].T,)

    def segsample():
        lg_seg = lgssm_of(k, t, NOISE, y.dtype)
        return (segmented.segmented_posterior_sample(gen, lg_seg, y, samples, seg,
                                                     num_blocks=num_blocks),)

    def psmooth():
        mean, var, _ = pallas_smooth(lg, y)
        return mean, var

    return {
        "filter": lambda: blocked.blocked_decorrelate(lg, y, num_blocks),
        "smooth": smooth,
        "smooth-split": smooth_split,
        "segfilter": lambda: segmented.segmented_decorrelate_t(k, t, NOISE, y, seg,
                                                               num_blocks=num_blocks,
                                                               dtype=y.dtype),
        "segsmooth": segsmooth,
        "ffbs": ffbs,
        "segsample": segsample,
        "seq": lambda: kalman.decorrelate(lg, y),
        "assoc": lambda: pkalman.parallel_decorrelate(lg, y),
        "pallas filter": lambda: decorrelate_blocked(lg, y, num_blocks),
        "pallas smooth": psmooth,
    }


def run(N=1_000_000, rows=None, *, device, reps=10, num_blocks=None, segment=None, samples=4,
        seed=0):
    """Time the rows ``rows`` (``ROWS``' names) on ``device`` and print the
    script's lines.  Returns {row: dict(first_s, s, ll, out)}, ``out`` the
    row's outputs (the ll and whitened innovations of a filter, the smoothed
    means and variances of a smoother, the draws (S, N) of a sampler)."""
    from gpar_at_scale_torch.ssm.blocked import num_blocks_for
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    device = torch.device(device)
    rows = ("filter", "smooth", "seq") if rows is None else tuple(rows)
    t_np, y_np = series(N, seed)
    t = torch.as_tensor(t_np, device=device)
    y = torch.as_tensor(y_np).to(device, torch.float32)
    lg = lgssm_of(kernel(device), t, NOISE, torch.float32)
    fns = row_fns(t, y, lg, num_blocks=num_blocks, segment=segment, samples=samples, seed=seed)
    nb = num_blocks_for(N, num_blocks)
    print(f"N={N}  device={device_name(device)}", flush=True)
    out = {}
    for row in rows:
        if row not in fns:
            raise ValueError(f"unknown row {row!r}: one of {ROWS}")
        # the script's repetitions per row (:274, :282, :337-344, :353-354)
        r = reps if row in ("filter", "pallas filter") else max(1, reps // 2)
        if row in ("seq", "assoc", "segfilter", "segsmooth", "segsample", "ffbs"):
            r = min(r, 3 if row.startswith("seg") or row == "ffbs" else 2)
        with torch.no_grad():
            first, el, res = time_call(fns[row], r, device)
        ll = float(torch.as_tensor(res[0]).double().sum())
        name = {"filter": f"blocked filter B={nb}", "smooth": f"blocked smooth B={nb}",
                "seq": "seq scan", "assoc": "assoc scan"}.get(row, row)
        out[row] = dict(first_s=first, s=el, ll=ll, out=res)
        print(f"{name:>14}: first {first:6.1f}s  run {el * 1e3:9.2f} ms "
              f"({N / el / 1e6:7.2f} M steps/s)  ll={ll:.1f}", flush=True)
        if row in ("ffbs", "segsample"):
            f = res[0]
            print(f"    {f.shape[0]} joint draws x {N:,} steps: "
                  f"{f.shape[0] * N / el / 1e6:7.2f} M sample-steps/s (the filter included); "
                  f"draw mean {float(f.mean()):.4f} sd {float(f.std()):.4f}", flush=True)
    for row, base in (("seq", "filter"), ("assoc", "filter")):
        if row in out and base in out:
            print(f"blocked speedup vs {row}: {out[row]['s'] / out[base]['s']:.1f}x")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = device_from_argv(argv)
    n = positional(argv)
    only = next((a.split("=", 1)[1] for a in argv if a.startswith("--only=")), None)
    rows = [r for r in ("filter", "smooth") if only in (None, r)]
    rows += [only] if only not in (None, "filter", "smooth", "seq", "assoc") else []
    rows += ["pallas filter", "pallas smooth"] if "--pallas" in argv else []
    rows += ["seq"] if ("--no-seq" not in argv and only is None) or only == "seq" else []
    rows += ["assoc"] if "--assoc" in argv or only == "assoc" else []
    nb = int_arg(argv, "blocks", None)
    return run(int(n) if n else 1_000_000, rows, device=device, reps=int_arg(argv, "reps", 10),
               num_blocks=nb, segment=int_arg(argv, "segment", None),
               samples=int_arg(argv, "samples", 4))


if __name__ == "__main__":
    main()
