"""Training traffic: whole type-II fits of one scaled GPAR conditional, back
to back, closed loop, one fit at a time.

Every fit is ``models/gpar.py::fit_conditional`` on the cell's series
(its sort, ``steps_per_fit`` Adam steps on the DTC bound through the scan
kernels, q(u) at the end) from a new start drawn from the seed around the
configuration's ``start``.  Set-up makes the data on the device and runs
fit 0, which builds and warms every kernel of the window's shapes; the
window runs fits 1, 2, ... until ``seconds`` have passed and finishes the
last.  ``train_step_ms`` is the window's seconds over its Adam steps.

What each step's optimizer got (parameters and gradient) is recorded by
a pre-step hook common to all optimizers: one small copy per step.  Fit 0
and one window fit drawn from the seed are then followed by the plain
reference (``compare.train_numbers``).
"""

from __future__ import annotations

import random
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from portbench import compare, stats
from portbench.data import million_dtc
from portbench.roofline import scan

PLAIN_PIECES = 3  # untraced fits timed in the traced run


class FitOut(NamedTuple):
    x0: torch.Tensor
    losses: torch.Tensor  # (steps,) the loss at each evaluated point
    steps: int
    xs: list  # parameters the optimizer held before each step
    gs: list  # the gradient it got at each step
    final: torch.Tensor  # parameters after the last step
    qu: tuple  # (m_eps, L_D, L_uu) at the final parameters


class Recorder:
    """Pre-step hook: the parameters and gradient each Adam step gets."""

    def __init__(self):
        self.steps = []

    def __call__(self, opt, args, kwargs):
        p = opt.param_groups[0]["params"][0]
        self.steps.append((p.detach().clone(), p.grad.detach().clone()))


def _gpar():
    # looked up at each call, so that a test can break the program underneath
    from gpar_at_scale_torch.models import gpar

    return gpar


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class State:
    def __init__(self, run):
        from gpar_at_scale_torch.config import kernel_family

        cfg, mix = run.cell.config, run.cell.traffic
        self.run, self.cfg, self.mix, self.device = run, cfg, mix, run.device
        gen = torch.Generator(device=run.device).manual_seed(run.seed)
        self.data = million_dtc.make(mix["n"], gen)
        _sync(self.device)
        self.stages = [("data", time.perf_counter())]
        gm = _gpar()
        self.gcfg = gm.GPARConfig(
            time_family=kernel_family(cfg["time_kernel"]), out_family=kernel_family(cfg["output_kernel"]),
            backend="scaled", filter_impl=cfg["filter_impl"], num_pseudo_points=cfg["num_pseudo_points"],
            dtype=getattr(torch, cfg["dtype"]), optimizer="adam", max_opt_steps=mix["steps_per_fit"])
        self.rng = np.random.default_rng(run.seed)
        self.base = np.log(np.asarray(cfg["start"], dtype=np.float64) - 1e-3)
        self.recorder = Recorder()
        self.hook = register_optimizer_step_pre_hook(self.recorder)
        self.pick = random.Random(run.seed)
        self.first = self.fit()
        _sync(self.device)
        self.stages.append(("warm-up fit", time.perf_counter()))

    def fit(self) -> FitOut:
        """The next fit, from a start drawn from the seed."""
        x0 = torch.as_tensor(self.base + self.cfg["start_sd"] * self.rng.normal(size=self.base.size),
                             dtype=self.gcfg.dtype, device=self.device)
        i0 = len(self.recorder.steps)
        d = self.data
        f = _gpar().fit_conditional(None, d.t, d.X, d.y, self.gcfg, init_params=x0, device=self.device)
        rec = self.recorder.steps[i0:]
        del self.recorder.steps[i0:]
        return FitOut(x0, f.opt.trace, f.opt.num_steps, [x for x, _ in rec],
                      [g for _, g in rec], f.params, (f.qu.m_eps, f.qu.L_D, f.qu.L_uu))


def setup(run) -> State:
    return State(run)


def window(run, st: State) -> dict:
    """Fits back to back until ``run.seconds`` have passed."""
    fits, chosen, steps, ends = [], None, 0, []
    t0 = time.perf_counter()
    while True:
        out = st.fit()
        _sync(st.device)
        ends.append(time.perf_counter())
        fits.append(out)
        steps += out.steps
        if st.pick.random() < 1.0 / len(fits):  # a uniform pick over the window's fits
            chosen = out
        if time.perf_counter() - t0 >= run.seconds:
            break
    window_s = time.perf_counter() - t0
    st.checked = [st.first, chosen]
    return {"window_s": window_s, "attempted": len(fits), "failed": _failed(st, fits),
            "metrics": {"train_step_ms": stats.per_unit_ms(window_s, steps)},
            "notes": f"{len(fits)} fits, {steps} Adam steps in {window_s:.3f} s; a fit's seconds: "
                     + quartiles(np.diff([t0] + ends))}


def _failed(st, fits) -> int:
    """Fits that stopped short of their steps or met a non-finite loss."""
    return sum(1 for f in fits if f.steps < st.mix["steps_per_fit"]
               or not bool(torch.isfinite(f.losses).all()))


def quartiles(xs) -> str:
    q = np.quantile(np.asarray(xs), [0.0, 0.25, 0.5, 0.75, 1.0])
    return "min {:.4f}, quartiles {:.4f} {:.4f} {:.4f}, max {:.4f}".format(*q)


def traced_window(run, st: State, traced) -> dict:
    """One fit under the profiler, tracing the device alone; the per-layer
    readings' context.  A second fit, traced with the host's operations,
    labels the idle gaps of the breakdown, and ``PLAIN_PIECES`` fits timed
    untraced before them give the wall time that the idle share and the
    peak's share are taken over."""
    from gpar_at_scale_torch.ops import launch_counts

    plain = []
    for _ in range(PLAIN_PIECES):  # first: a profiler that has run slows later launches
        a = time.perf_counter()
        f = st.fit()
        _sync(st.device)
        plain.append((f, time.perf_counter() - a))
    before = launch_counts()
    out, tr = traced(st.fit)
    after = launch_counts()
    delta = {k.split()[0]: after[k] - before[k] for k in after}
    for name, parts in scan.DEVICE_KERNELS.items():
        for frag, per in parts:
            if tr.count(frag) != per * delta[name]:
                raise RuntimeError(
                    f"the trace holds {tr.count(frag)} {frag} records where {name}'s counter "
                    f"says {per * delta[name]}: the profiler lost device records")
    second, host_tr = traced(st.fit, host=True)
    st.checked = [st.first, out]
    cfg = st.cfg
    ctx = {"trace": tr, "host_trace": host_tr, "plain_s": float(np.mean([s for _, s in plain])),
           "launches": delta, "steps": out.steps, "fits": 1,
           "n": st.mix["n"], "M": cfg["num_pseudo_points"], "D": cfg["num_inputs"],
           "d": cfg["state_dim"]}
    fits = [out, second] + [f for f, _ in plain]
    return {"window_s": tr.window_s, "attempted": len(fits), "failed": _failed(st, fits),
            "context": ctx,
            "notes": f"traced fit: {out.steps} steps, {1e3 * tr.window_s / out.steps:.3f} ms a step "
                     f"tracing the device, {1e3 * host_tr.window_s / second.steps:.3f} with the host, "
                     f"{1e3 * ctx['plain_s'] / out.steps:.3f} untraced"}


def release(st: State):
    """Drop what the program holds before the reference runs."""
    st.hook.remove()
    st.recorder.steps.clear()


def check(run, st: State, ref) -> dict:
    """The numbers compared, worst over the checked fits."""
    mix, d = st.mix, st.data
    inp = ref.Inputs(d.t, d.X, d.y, ref.pseudo_inputs(d.X, st.cfg["num_pseudo_points"]))
    k = mix["check_steps"]
    out = []
    for f in st.checked:
        traj = ref.adam_follow(f.x0, inp, k, lr=st.cfg["learning_rate"])
        u_mean, u_var = compare.u_posterior(*f.qu)
        out.append(compare.train_numbers(
            [float(v) for v in f.losses[:k]], f.gs, f.xs + [f.final], u_mean, u_var, traj,
            ref.q_u(f.final, inp), k))
    return compare.worst(out)



def control_numbers(run, st: State, ref) -> dict:
    """The numbers with the reference's control in the program's place:
    fit 0's first steps and q(u) at the precision below the configuration's."""
    d, k = st.data, st.mix["check_steps"]
    inp = ref.Inputs(d.t, d.X, d.y, ref.pseudo_inputs(d.X, st.cfg["num_pseudo_points"]))
    x0, lr = st.first.x0, st.cfg["learning_rate"]
    low = ref.adam_follow(x0, inp, k, lr=lr, prec=ref.CONTROL)
    u_mean, u_var = ref.q_u(low.params[k], inp, ref.CONTROL)
    return compare.train_numbers(low.losses, low.grads, low.params, u_mean, u_var,
                                 ref.adam_follow(x0, inp, k, lr=lr), ref.q_u(low.params[k], inp), k)
