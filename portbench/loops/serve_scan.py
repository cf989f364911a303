"""Long-series serving traffic: predictive requests at held-out times against
the q(u) of a conditional fitted in set-up, closed loop, one request in
flight.

Set-up makes the series on the device (``data/million_dtc.py``) and the
configuration's held-out times (``n_star`` uniform on [0, n / 1000), drawn
from the seed, X* = ``xcols(t*)``), fits it with the users' entry,
``models/gpar.py::fit_conditional`` (``fit_steps`` Adam steps from the
configuration's ``start`` plus N(0, ``start_sd``^2) drawn from the seed;
q(u) at the end), draws the configuration's ``draws`` hyperparameter sets
around the fit's log-parameters (``draw_sd`` normal) and answers request 0,
which warms every shape.

The traffic's ``request`` says what one request is:

* ``batch``: one ``gp/dtc.py::predict_scaled_batch`` of the draws, each
  request's draws moved by an offset of its own (``batch_offset_sd``
  normal, drawn when it is sent), at the held-out times;
* ``single``: one ``FittedConditional.predict`` at the held-out times, at
  the fit's log-parameters moved by such an offset.

Each is timed from its call to the synchronize after it; the next is sent
when it returns.  ``obs_per_s`` counts draws x held-out times a request
over the window's seconds; ``request_p95_ms`` is the 95th percentile over
every request.  The fit's first ``check_steps`` Adam steps (loss, first
gradient, change of the parameters; recorded by ``train_fits``'s pre-step
hook) and its q(u) are held to the plain reference as a training cell's
fit is; the warm-up request and a uniform sample of ``check_batches``
window requests are held to the reference's predictive at the fit's
log-parameters, each by ``check_draws`` of its draws drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import random
import time
from contextlib import contextmanager

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from portbench import compare, faults, stats
from portbench.data import million_dtc
from portbench.loops.serve_batches import _serve, _sync, release  # noqa: F401
from portbench.loops.train_fits import FitOut, Recorder

PLAIN_PIECES = 3  # pieces of trace_batches requests timed untraced in the traced run


def _program():
    # looked up at each call, so that a fault can break the program underneath
    from gpar_at_scale_torch.gp import dtc

    return dtc


def _gpar():
    from gpar_at_scale_torch.models import gpar

    return gpar


def held_out(n: int, n_star: int, gen: torch.Generator, dtype=torch.float32):
    """(t*, X*): ``n_star`` times uniform on [0, n / 1000) from ``gen``, in the
    order drawn, and their inputs ``xcols(t*)``, cast to ``dtype``."""
    ts = torch.rand(n_star, generator=gen, dtype=torch.float64, device=gen.device) * (n / 1000.0)
    return ts.to(dtype), million_dtc.xcols(ts).to(dtype)


class State:
    def __init__(self, run):
        from gpar_at_scale_torch.config import kernel_family

        cfg, mix = run.cell.config, run.cell.traffic
        self.run, self.cfg, self.mix, self.device = run, cfg, mix, run.device
        self.dtype = dtype = getattr(torch, cfg["dtype"])
        self.gen = gen = torch.Generator(device=run.device).manual_seed(run.seed)
        self.data = million_dtc.make(cfg["n"], gen, dtype)
        self.t_star, self.X_star = held_out(cfg["n"], cfg["n_star"], gen, dtype)
        _sync(self.device)
        self.stages = [("data", time.perf_counter())]
        gm = _gpar()
        self.gcfg = gm.GPARConfig(
            time_family=kernel_family(cfg["time_kernel"]), out_family=kernel_family(cfg["output_kernel"]),
            backend="scaled", filter_impl=cfg["filter_impl"], num_pseudo_points=cfg["num_pseudo_points"],
            dtype=dtype, optimizer="adam", max_opt_steps=cfg["fit_steps"])
        rng = np.random.default_rng(run.seed)
        base = np.log(np.asarray(cfg["start"], dtype=np.float64) - 1e-3)
        x0 = torch.as_tensor(base + cfg["start_sd"] * rng.normal(size=base.size), dtype=dtype,
                             device=self.device)
        d = self.data
        rec = Recorder()
        hook = register_optimizer_step_pre_hook(rec)
        try:
            self.fit = f = gm.fit_conditional(None, d.t, d.X, d.y, self.gcfg, init_params=x0,
                                              device=self.device)
        finally:
            hook.remove()
        self.fit_out = FitOut(x0, f.opt.trace, f.opt.num_steps, [x for x, _ in rec.steps],
                              [g for _, g in rec.steps], f.params, (f.qu.m_eps, f.qu.L_D, f.qu.L_uu))
        _sync(self.device)
        self.stages.append(("fit", time.perf_counter()))
        self.params = self.fit.params.detach()
        self.batched = mix["request"] == "batch"
        b = cfg["draws"] if self.batched else 1
        self.base = self.params[None, :] + (cfg["draw_sd"] if self.batched else 0.0) * torch.randn(
            b, 5, generator=gen, device=self.device, dtype=dtype)
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
        self.served = 0
        self.pick = random.Random(run.seed)
        self.checked = [self.request()]
        _sync(self.device)
        self.stages.append(("warm-up request", time.perf_counter()))

    def next_draws(self):
        """The next request's draws (b, 5): the shared ones moved by an
        offset of its own."""
        return self.base + self.cfg["batch_offset_sd"] * torch.randn(
            5, generator=self.gen, device=self.device, dtype=self.dtype)

    def request(self):
        """(draws (b, 5), mean (b, n*), var (b, n*)) of the next request."""
        draws, f = self.next_draws(), self.fit
        with torch.no_grad():
            if not self.batched:
                mean, var = dataclasses.replace(f, params=draws[0]).predict(self.t_star, self.X_star)
                return draws, mean[None], var[None]
            from gpar_at_scale_torch.kernels import Matern52
            from gpar_at_scale_torch.utils.params import unpack_gpar

            tl, ts, ol, osig, ns = unpack_gpar(draws.T)
            pred = _program().predict_scaled_batch(
                Matern52(lengthscale=ol, variance=osig**2), Matern52(lengthscale=tl, variance=ts**2),
                f.qu, f.X_prev, f.t, f.y, self.t_star, self.X_star, ns**2, dtype=self.dtype)
        return draws, pred.mean, pred.var

    @property
    def draws_per_request(self):
        return self.base.shape[0]


def setup(run) -> State:
    return State(run)


def window(run, st: State) -> dict:
    lat, window_s = _serve(st, lambda n, s: s >= run.seconds)
    return _result(st, lat, window_s)


def _result(st, lat, window_s) -> dict:
    n_req = len(lat)
    obs = n_req * st.draws_per_request * st.cfg["n_star"]
    return {"window_s": window_s, "attempted": n_req, "failed": int(st.nonfinite),
            "metrics": {"obs_per_s": stats.rate(obs, window_s),
                        "request_p95_ms": 1e3 * stats.percentile(lat, 95)},
            "notes": f"{n_req} requests, {obs} observations in {window_s:.3f} s, "
                     f"median request {1e3 * stats.percentile(lat, 50):.4f} ms"}


def traced_window(run, st: State, traced) -> dict:
    """``trace_batches`` requests traced with the program's spans on
    (``portbench/spans.py::traced_spans``: host and device, each device
    record under the spans open at its launch), after ``PLAIN_PIECES``
    times as many timed untraced, whose wall time the idle share and the
    peak's share are taken over.  The launch counters around the traced
    requests go in the context."""
    from gpar_at_scale_torch.ops import launch_counts

    from portbench.spans import traced_spans

    n = st.mix["trace_batches"]
    # untraced first: a profiler that has run slows later launches
    lat_plain, plain_s = _serve(st, lambda c, s: c >= PLAIN_PIECES * n)
    before = launch_counts()
    (lat, window_s), span_tr = traced_spans(lambda: _serve(st, lambda c, s: c >= n))
    after = launch_counts()
    out = _result(st, lat_plain + lat, plain_s + window_s)
    cfg = st.cfg
    out["context"] = {"trace": span_tr.trace, "host_trace": span_tr.trace, "span_trace": span_tr,
                      "plain_s": plain_s / PLAIN_PIECES, "requests": len(lat),
                      "launches": {k.split()[0]: after[k] - before[k] for k in after},
                      "b": st.draws_per_request, "n": cfg["n"], "n_star": cfg["n_star"],
                      "M": cfg["num_pseudo_points"], "D": cfg["num_inputs"], "d": cfg["state_dim"]}
    out["notes"] = (f"traced: {len(lat)} requests in {window_s:.4f} s with spans, host and device, "
                    f"{len(lat)} in {out['context']['plain_s']:.4f} s untraced")
    return out


def _inputs(st: State, ref):
    d = st.data
    return ref.Inputs(d.t, d.X, d.y, ref.pseudo_inputs(d.X, st.cfg["num_pseudo_points"]),
                      st.t_star, st.X_star)


def _rows(st: State, b: int, rng: random.Random):
    """The draws of a checked request held to the reference, from ``rng``."""
    return sorted(rng.sample(range(b), min(b, st.mix["check_draws"])))


def _fit_reference(st: State, ref, inp, prec=None):
    """The reference's Adam from the fit's start for ``check_steps`` steps."""
    binp = ref.base.Inputs(inp.t, inp.X, inp.y, inp.Z)
    kw = {} if prec is None else {"prec": prec}
    return ref.base.adam_follow(st.fit_out.x0, binp, st.mix["check_steps"],
                                lr=st.cfg["learning_rate"], **kw)


def check(run, st: State, ref) -> dict:
    inp = _inputs(st, ref)
    rq = ref.q_u(st.params, inp)
    f, k = st.fit_out, st.mix["check_steps"]
    u_mean, u_var = compare.u_posterior(*f.qu)
    out = [compare.train_numbers([float(v) for v in f.losses[:k]], f.gs, f.xs + [f.final], u_mean,
                                 u_var, _fit_reference(st, ref, inp), (rq.u_mean, rq.u_var), k)]
    rng = random.Random(run.seed + 1)
    for draws, mean, var in st.checked:
        rows = _rows(st, draws.shape[0], rng)
        rm, rv = ref.predict(draws[rows], rq, inp)
        out.append(compare.serve_numbers(mean[rows], var[rows], rm, rv))
    return compare.worst(out)


def control_numbers(run, st: State, ref) -> dict:
    """The numbers with the reference's control in the program's place: the
    fit's first steps from its start, its q(u) at the fit's parameters and
    its answers to the warm-up request's draws and as many requests more as
    a run checks."""
    inp = _inputs(st, ref)
    rq, cq = ref.q_u(st.params, inp), ref.q_u(st.params, inp, ref.CONTROL)
    low = _fit_reference(st, ref, inp, ref.CONTROL)
    out = [compare.train_numbers(low.losses, low.grads, low.params, cq.u_mean, cq.u_var,
                                 _fit_reference(st, ref, inp), (rq.u_mean, rq.u_var),
                                 st.mix["check_steps"])]
    rng = random.Random(run.seed + 1)
    for draws in [st.checked[0][0]] + [st.next_draws() for _ in range(st.mix["check_batches"])]:
        rows = _rows(st, draws.shape[0], rng)
        rm, rv = ref.predict(draws[rows], rq, inp)
        cm, cv = ref.predict(draws[rows], cq, inp, ref.CONTROL)
        out.append(compare.serve_numbers(cm, cv, rm, rv))
    return compare.worst(out)


# ---------------------------------------------------------------------------
# Faults planted in the program underneath the timed path (the tests and the
# limits' calibration): each replaces one program function by name
# ---------------------------------------------------------------------------


@contextmanager
def half_batch():
    """Half the work left out: in a batched request half of the draws, the
    mean over the rest answered in their place; in a single request every
    other training step, the series of the other half dropped."""
    def batch(orig):
        def half(*args, **kw):
            p = orig(*args, **kw)
            b = p.mean.shape[0] // 2
            fill = lambda x: torch.cat([x[:b], x[:b].mean(0, keepdim=True).expand(x.shape[0] - b, -1)])  # noqa: E731
            return p._replace(mean=fill(p.mean), var=fill(p.var))
        return half

    def single(orig):
        def half(out_k, time_k, qu, V, t, y, *args, **kw):
            return orig(out_k, time_k, qu, V[::2], t[::2], y[::2], *args, **kw)
        return half

    with faults._patched(_program(), "predict_scaled_batch", batch), \
            faults._patched(_gpar(), "predict_scaled", single):
        yield


@contextmanager
def answer_altered():
    """Each draw's predictive mean at its first held-out time moved by a
    tenth of its sd where it is produced (a request checks some of its
    draws, not all)."""
    def make(orig):
        def altered(*args, **kw):
            p = orig(*args, **kw)
            mean = p.mean.clone()
            mean[..., 0] += 0.1 * p.var[..., 0].clamp_min(0).sqrt()
            return p._replace(mean=mean)
        return altered

    with faults._patched(_program(), "predict_scaled_batch", make), \
            faults._patched(_gpar(), "predict_scaled", make):
        yield


FAULTS = {"half_batch": half_batch, "answer_altered": answer_altered,
          "state_unchanged": faults.state_unchanged}
