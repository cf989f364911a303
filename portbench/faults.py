"""Faults planted in the program underneath the timed path, for the checks
that the comparison catches them: the CPU tests drive a run with each, and
``calibrate.py`` reads them on the card at a cell's own size.

Each fault is a context manager that replaces one program function for its
duration, by name, as the loops look them up at each call.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextmanager
def state_unchanged():
    """Every optimizer step returns its state unchanged."""
    orig = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


@contextmanager
def train_half_batch():
    """The training loss of every other row, the mean over those rows taken
    for all: twice the bound of the half series."""
    from gpar_at_scale_torch.models import gpar
    from gpar_at_scale_torch.ssm.markov import lgssm_of

    def make(orig):
        def half(out_k, lgssm, V, Z, y, *args, time_kernel=None, t=None, **kw):
            lg = lgssm_of(time_kernel, t[::2], lgssm.R[::2], lgssm.A.dtype)
            return 2.0 * orig(out_k, lg, V[::2], Z, y[::2], *args, time_kernel=time_kernel,
                              t=t[::2], **kw)
        return half

    with _patched(gpar, "dtc_objective", make):
        yield


@contextmanager
def train_answer_altered():
    """q(u), the fit's answer, altered where it is produced: its whitened
    mean moved by a tenth of its largest entry in one place."""
    from gpar_at_scale_torch.models import gpar

    def make(orig):
        def altered(*args, **kw):
            qu = orig(*args, **kw)
            m = qu.m_eps.clone()
            m[0] += 0.1 * m.abs().max()
            return qu._replace(m_eps=m)
        return altered

    with _patched(gpar, "compute_q_u", make):
        yield


@contextmanager
def serve_half_batch():
    """Half of each batch's draws left out, the mean over the rest answered
    in their place."""
    from gpar_at_scale_torch.gp import dtc

    def make(orig):
        def half(*args, **kw):
            p = orig(*args, **kw)
            b = p.mean.shape[0] // 2
            fill = lambda x: torch.cat([x[:b], x[:b].mean(0, keepdim=True).expand(x.shape[0] - b, -1)])  # noqa: E731
            return p._replace(mean=fill(p.mean), var=fill(p.var))
        return half

    with _patched(dtc, "predict_scaled_batch", make):
        yield


@contextmanager
def serve_answer_altered():
    """One predictive mean of each batch moved by a tenth of its sd where
    it is produced."""
    from gpar_at_scale_torch.gp import dtc

    def make(orig):
        def altered(*args, **kw):
            p = orig(*args, **kw)
            mean = p.mean.clone()
            mean[0, 0] += 0.1 * p.var[0, 0].clamp_min(0).sqrt()
            return p._replace(mean=mean)
        return altered

    with _patched(dtc, "predict_scaled_batch", make):
        yield


TRAIN = {"state_unchanged": state_unchanged, "half_batch": train_half_batch,
         "answer_altered": train_answer_altered}
SERVE = {"half_batch": serve_half_batch, "answer_altered": serve_answer_altered}
BY_LOOP = {"train_fits": TRAIN, "serve_batches": SERVE}
