"""Sharded multi-chain training of the DTC hyperparameters.

Counterpart of ``gpar_at_scale_tpu/parallel/sharded.py``.  The C chains'
parameters and Adam state are split over the mesh's ``"chain"`` axis; the
observations (t, X, y) are split by time over its ``"data"`` axis and the
pseudo-inputs Z are replicated.  Each rank steps its own chains.

With a data axis of size 1 a chain's objective is the port's unsharded one
(``make_dtc_nlml``: ``gp.dtc.dtc_objective`` on the scan kernels in
float32, on the tensor-code blocked engine otherwise).  Above 1 the Gram of
the M + 1 columns runs through the time-sharded filter of
``parallel/seqshard.py`` over the data axis: each rank discretizes and
whitens its own span (``ShardedWhiten``: K1/K2 forward, K4a/K4b backward
on the kernels), G and log det are summed over the axis in float64, and the
M x M algebra is the same on every rank.  The gradient is exact on every
rank: the span's share of the hyperparameters' cotangent is summed over the
data axis (``distributed.sum_grads``), the M x M algebra's is not.  The
optimizer is the port's Adam (``inference.optimize.adam_update``, the
update of ``torch.optim.Adam`` with optax's defaults).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from gpar_at_scale_torch.gp.dtc import DTCIntermediates, dtc_bound, dtc_objective
from gpar_at_scale_torch.inference.optimize import AdamState, adam_init, adam_update
from gpar_at_scale_torch.kernels import Matern52
from gpar_at_scale_torch.parallel.distributed import all_gather, sum_grads
from gpar_at_scale_torch.parallel.mesh import axis_group, axis_rank, axis_size, shard_along, spans
from gpar_at_scale_torch.parallel.seqshard import TimeAxis, _whiten_span
from gpar_at_scale_torch.ssm.markov import LGSSM, lgssm_of
from gpar_at_scale_torch.utils.params import unpack_gpar
from gpar_at_scale_torch.utils.psd import cholesky_psd, default_jitter


def _engine(dtype) -> str:
    return "pallas" if dtype == torch.float32 else "blocked"


def make_dtc_nlml(out_family=Matern52, time_family=Matern52, dtype=torch.float32):
    """The scaled-GPAR negative DTC objective as a function of
    (params, t, X, y, Z): the scan kernels in float32 (sum-kernel SDEs the
    associative engine), the tensor-code blocked engine in float64."""

    def nlml(params, t, X, y, Z):
        tl, ts, ol, osig, ns = unpack_gpar(params)
        lgssm = lgssm_of(time_family(lengthscale=tl, variance=ts**2), t, ns**2, dtype)
        out_k = out_family(lengthscale=ol, variance=osig**2)
        return -dtc_objective(out_k, lgssm, X, Z, y, filter_fn=_engine(dtype))

    return nlml


def _span_nlml(ax: TimeAxis, n: int, out_family, time_family, dtype):
    """The negative DTC objective of a time-sharded series from this rank's
    span: t_ext is the span's times with the left neighbour's point in front
    (but on the first rank) and the right neighbour's behind (but on the
    last), so each span's transitions are the whole series' own."""
    first = ax.rank == 0

    def nlml(params, t_ext, X, y, Z):
        p_span = sum_grads(params, ax.group)
        tl, ts, ol, osig, ns = unpack_gpar(p_span)
        lg = lgssm_of(time_family(lengthscale=tl, variance=ts**2), t_ext, ns**2, dtype)
        if not first:  # the left neighbour's point: its prior row goes
            lg = LGSSM(A=lg.A[1:], Q=lg.Q[1:], H=lg.H, R=lg.R.expand(lg.num_steps)[1:], e1=lg.e1)
        out_k = out_family(lengthscale=ol, variance=osig**2)
        U = torch.cat([y[:, None], out_k(X, Z)], dim=1)
        G, logdet, _ = _whiten_span(ax, lg, U, full=False)
        _, _, ol_r, os_r, ns_r = unpack_gpar(params)
        m = Z.shape[0]
        Kuu = out_family(lengthscale=ol_r, variance=os_r**2)(Z, Z)
        Kuu = Kuu + ns_r**2 * torch.eye(m, dtype=Kuu.dtype, device=Kuu.device)
        L_uu = cholesky_psd(Kuu.double(), default_jitter(Kuu.dtype))
        inter = DTCIntermediates(aa=G[0, 0], g=G[1:, 0], Gb=G[1:, 1:], L_uu=L_uu,
                                 logdet_noise=logdet)
        return -dtc_bound(inter, n)

    return nlml


class TrainState(NamedTuple):
    params: torch.Tensor  # (C / chain size, 5) this rank's chains' log-params
    opt_state: AdamState


def make_sharded_train_step(
    mesh,
    *,
    out_family=Matern52,
    time_family=Matern52,
    learning_rate: float = 1e-2,
    dtype=torch.float32,
) -> Tuple[Callable, Callable, Callable]:
    """(init_fn, step_fn, place_fn) for multi-chain DTC hyperparameter
    optimization on ``mesh`` (axes "chain" and "data").

    ``place(params (C, 5), t, X, y, Z)`` gives this rank its chains (C must
    divide over the chain axis) and its time span of (t, X, y) (t with the
    neighbours' points, see ``_span_nlml``), all in ``dtype``, and Z whole.
    ``init(params)`` starts Adam.  ``step(state, t, X, y, Z)`` takes one
    Adam step of every chain of this rank and returns (state, loss (C,)):
    the losses of all C chains, before the step, on every rank."""
    chain_g, data_g = axis_group(mesh, "chain"), axis_group(mesh, "data")
    n_chain, n_data = axis_size(mesh, "chain"), axis_size(mesh, "data")
    r_data = axis_rank(mesh, "data")
    full_nlml = make_dtc_nlml(out_family, time_family, dtype)

    def place(params_batch, t, X, y, Z):
        params_batch = torch.as_tensor(params_batch).to(dtype)
        if params_batch.shape[0] % n_chain:
            raise ValueError(f"{params_batch.shape[0]} chains do not divide over a chain axis "
                             f"of {n_chain}")
        params_batch = shard_along(mesh, "chain", params_batch)
        t, X, y, Z = (torch.as_tensor(a) for a in (t, X, y, Z))
        X, y, Z = X.to(dtype), y.to(dtype), Z.to(dtype)
        if n_data == 1:
            return params_batch, t, X, y, Z
        n = t.shape[0]
        s, ln = spans(n, n_data)[r_data]
        return params_batch, t[max(s - 1, 0):min(s + ln + 1, n)], X[s:s + ln], y[s:s + ln], Z

    def init(params_batch) -> TrainState:
        return TrainState(params=params_batch, opt_state=adam_init(params_batch))

    def step(state: TrainState, t, X, y, Z):
        if n_data == 1:
            nlml = full_nlml
        else:
            counts = all_gather(torch.tensor([y.shape[0]], device=y.device), data_g)
            counts = [int(c) for c in counts]
            sp = [(sum(counts[:r]), c) for r, c in enumerate(counts)]
            nlml = _span_nlml(TimeAxis(data_g, n_data, r_data, sp), sum(counts), out_family,
                              time_family, dtype)
        losses, grads = [], []
        for p in state.params:
            p = p.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = nlml(p, t, X, y, Z)
            (g,) = torch.autograd.grad(loss, p)
            losses.append(loss.detach())
            grads.append(g)
        params, opt_state = adam_update(torch.stack(grads), state.opt_state, state.params,
                                        learning_rate)
        loss = torch.cat(all_gather(torch.stack(losses), chain_g))
        return TrainState(params=params, opt_state=opt_state), loss

    return init, step, place
