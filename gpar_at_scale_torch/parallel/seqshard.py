"""Time-block-sharded Kalman filter, smoother and whitened Gram (sequence
parallelism) over one axis of a mesh.

Counterpart of ``gpar_at_scale_tpu/parallel/seqshard.py``.  Rank k of the
axis owns one contiguous span of the N steps (``mesh.spans``: the spans may
differ by one step, so N need not divide) and runs the three phases of the
JAX package on it:

  phase 1 (local)  -- the span's filtering elements, reduced to one rank
                      total (A, b, C, eta, J): on the scan kernels, K1 per
                      time block (``ops/kalman.py::phase1``), then the
                      blocks folded in float64; else the tensor-code
                      blocked engine (``ssm/blocked.py``);
  phase 2 (global) -- the D rank totals are all-gathered (one (d, d) and
                      (d, B)-sized tuple per rank) and every rank folds the
                      totals of the ranks before it in float64: the
                      filtered (m, P) entering its span;
  phase 3 (local)  -- the span is filtered from that carry: K2 replays the
                      blocks (``block_inits(init=)``, ``phase3``), or the
                      tensor-code replay.

The log-likelihood is summed across ranks in float64.  The smoother and the
gradients run the same three phases backwards over the suffix scan (K4a per
block, the rank totals all-gathered and folded as an exclusive suffix, K4b
replays; ``ops/smoother.py``): the carry into a span is the scanned state
of the later ranks at its right neighbour's first step.  The next-step
values the JAX package fetches from the right neighbour with ``ppermute``
(its transition, predicted moments) are computed locally instead: every
rank holds the LGSSM, and the predicted moments of step e are A_e m_{e-1},
A_e P_{e-1} A_e^T + Q_e from the span's own last filtered moments.  So the
only collectives are the two all-gathers of rank totals, the float64 sums,
and the gathers of per-step outputs to full length.

Route, per span: the scan kernels take float32 SDEs with d <= 3 and H = e1
(``ops.kalman.pallas_supported``), one launch of K1 and K2 per observation
column (K2 whitens one column from its init; K3, which starts every column
from a zero mean, is not used here); every other span (float64, sum
kernels) runs the tensor-code blocked engine.  On CPU tensors the kernels'
wrappers run their plain versions.

Contracts: ``make_sharded_filter(mesh, axis)`` returns a ``ShardedFilter``,
a ``filter_fn(lgssm, y) -> FilterResult`` that ``gp/dtc.py`` takes as its
whitening engine (``dtc_objective(..., filter_fn=make_sharded_filter(mesh))``
forms the Gram through ``ShardedFilter.gram``, differentiable).  Every rank
passes the whole series and gets whole-length outputs back.  The filter,
decorrelate and smoother are forward only and raise when an input requires
grad; ``logpdf`` and ``gram`` are differentiable through closed-form
backward passes (``ssm/blocked_grad.py``) split the same way, and give every
rank the whole series' cotangents (the span cotangents all-gathered).  On an
axis of size 1 each function is the unsharded engine's, call for call.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from gpar_at_scale_torch.parallel.distributed import all_gather, all_gather_rows, all_reduce_sum
from gpar_at_scale_torch.parallel.mesh import axis_group, axis_rank, axis_size, spans
from gpar_at_scale_torch.ssm.blocked import (
    _unblock,
    block_inits,
    block_totals,
    blocked_suffix_scan,
    num_blocks_for,
    replay_blocks,
    smoothing_elements,
)
from gpar_at_scale_torch.ssm.blocked_grad import whiten_bwd_elements, whiten_bwd_scores
from gpar_at_scale_torch.ssm.kalman import FilterResult, SmoothResult, _ensure_batch
from gpar_at_scale_torch.ssm.markov import LGSSM
from gpar_at_scale_torch.ssm.pkalman import _combine_fast, _combine_smooth, _smoother_elements

_LOG_2PI = 1.8378770664093453
_F32 = torch.float32


class TimeAxis(NamedTuple):
    """One rank's place on the time axis of an n-step series."""

    group: object  # the axis' process group; None on an axis of one rank
    size: int
    rank: int
    spans: List[Tuple[int, int]]  # (start, length) of every rank's span

    @property
    def start(self) -> int:
        return self.spans[self.rank][0]

    @property
    def length(self) -> int:
        return self.spans[self.rank][1]

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1

    @property
    def counts(self) -> List[int]:
        return [ln for _, ln in self.spans]


def time_axis(mesh, axis: str, n: int) -> TimeAxis:
    size = axis_size(mesh, axis)
    return TimeAxis(axis_group(mesh, axis), size, axis_rank(mesh, axis), spans(n, size))


def _on_kernels(lgssm: LGSSM) -> bool:
    from gpar_at_scale_torch.ops.kalman import pallas_supported

    return lgssm.A.dtype == _F32 and pallas_supported(lgssm)


# ---------------------------------------------------------------------------
# Rank totals and the carries between spans
# ---------------------------------------------------------------------------


def _fold(join, elems):
    """The ordered product of the elements along the leading axis (earlier
    first), by pairwise halving: ``join(earlier, later)``."""
    while elems[0].shape[0] > 1:
        n = elems[0].shape[0]
        h = n // 2
        out = join(tuple(x[0:2 * h:2] for x in elems), tuple(x[1:2 * h:2] for x in elems))
        if n % 2:
            out = tuple(torch.cat([o, x[-1:]]) for o, x in zip(out, elems))
        elems = out
    return tuple(x[0] for x in elems)


def _smooth_join(earlier, later):
    return _combine_smooth(later, earlier)


def _gather_totals(ax: TimeAxis, total):
    """Every rank's total element, in rank order, as float64 tuples: one
    all-gather of the flattened parts."""
    parts = [x.double() for x in total]
    flat = torch.cat([x.reshape(-1) for x in parts])
    out = []
    for row in all_gather(flat, ax.group):
        pieces, at = [], 0
        for x in parts:
            pieces.append(row[at:at + x.numel()].reshape(x.shape))
            at += x.numel()
        out.append(tuple(pieces))
    return out


def _carry_in(ax: TimeAxis, elems, dtype):
    """The filtered (m (d, B), P (d, d)) before this rank's span: the fold
    of the earlier ranks' totals (phase 2); None on the first rank."""
    if ax.size == 1:
        return None
    totals = _gather_totals(ax, _fold(_combine_fast, tuple(x.double() for x in elems)))
    if ax.rank == 0:
        return None
    acc = totals[0]
    for j in range(1, ax.rank):
        acc = _combine_fast(acc, totals[j])
    return acc[1].to(dtype), acc[2].to(dtype)


def _carry_back(ax: TimeAxis, elems, dtype):
    """The suffix scan's state (v (d, C), M (d, d)) at the step after this
    rank's span: the fold of the later ranks' totals applied to zero; None
    on the last rank."""
    if ax.size == 1:
        return None
    totals = _gather_totals(ax, _fold(_smooth_join, tuple(x.double() for x in elems)))
    if ax.last:
        return None
    acc = totals[-1]
    for j in range(ax.size - 2, ax.rank, -1):
        acc = _combine_smooth(acc, totals[j])
    return acc[1].to(dtype), acc[2].to(dtype)


# ---------------------------------------------------------------------------
# One rank's span: the filter forward, the suffix scan backward
# ---------------------------------------------------------------------------


class SpanFilter(NamedTuple):
    """The filter over one rank's span (n steps, B columns)."""

    ll: torch.Tensor  # (B,) float64, the span's log-likelihood
    alpha: torch.Tensor  # (n, B) whitened innovations v / sqrt(S)
    S: torch.Tensor  # (n,) innovation variances
    K: torch.Tensor  # (n, d) gains
    m: Optional[torch.Tensor]  # (n, d, B) filtered means, if asked for
    P: Optional[torch.Tensor]  # (n, d, d) filtered covariances, if asked for
    mp: Optional[torch.Tensor]  # (n, d, B) predicted means (tensor route)
    Pp: Optional[torch.Tensor]  # (n, d, d) predicted covariances (tensor route)
    v: Optional[torch.Tensor]  # (n, B) innovations (tensor route)
    init: Optional[tuple]  # the filtered (m, P) before the span; None on rank 0


def span_filter(ax: TimeAxis, lgssm: LGSSM, Y, moments=True) -> SpanFilter:
    """Phases 1-3 of the filter over this rank's span (``lgssm`` and Y
    (n, B) are the span's); the carry comes from the other ranks.  On the
    kernels: K1 per column, the block elements stacked over the columns for
    phase 2, K2 per column; else the tensor-code blocked filter's phases."""
    n = lgssm.num_steps
    nb = num_blocks_for(n)
    T = -(-n // nb)
    if _on_kernels(lgssm):
        from gpar_at_scale_torch.ops.kalman import phase1, phase3

        A, Q = lgssm.A.to(_F32).contiguous(), lgssm.Q.to(_F32).contiguous()
        R = lgssm.R.to(_F32).expand(n).contiguous()
        cols = [Y[:, c].to(_F32).contiguous() for c in range(Y.shape[1])]
        per = [phase1(A, Q, R, y, nb, T) for y in cols]
        elems = (per[0][0], torch.stack([p[1] for p in per], -1), per[0][2],
                 torch.stack([p[3] for p in per], -1), per[0][4])
        init = _carry_in(ax, elems, _F32)
        m0, P0 = block_inits(elems, init)
        P0 = P0.contiguous()
        outs = [phase3(A, Q, R, y, m0[:, :, c].contiguous(), P0, nb, T, c == 0, moments)
                for c, y in enumerate(cols)]
        return SpanFilter(
            ll=torch.stack([o[5].double().sum() for o in outs]),
            alpha=torch.stack([o[0] for o in outs], 1), S=torch.exp(outs[0][1]), K=outs[0][2],
            m=torch.stack([o[3] for o in outs], -1) if moments else None,
            P=outs[0][4], mp=None, Pp=None, v=None, init=init,
        )
    elems = block_totals(lgssm, Y, nb, T)
    init = _carry_in(ax, elems, lgssm.A.dtype)
    outs, _ = replay_blocks(lgssm, Y, *block_inits(elems, init), nb, T)
    o = {k: _unblock(v, n) for k, v in outs.items()}
    S = o["S"]
    ll = -0.5 * (_LOG_2PI + torch.log(S)[:, None] + o["v"] ** 2 / S[:, None]).sum(0)
    K = torch.einsum("nij,j->ni", o["Pp"], lgssm.H.to(S.dtype)) / S[:, None]
    return SpanFilter(ll=ll.double(), alpha=o["v"] / torch.sqrt(S)[:, None], S=S, K=K, m=o["m"],
                      P=o["P"], mp=o["mp"], Pp=o["Pp"], v=o["v"], init=init)


def _predicted(lgssm: LGSSM, sf: SpanFilter):
    """(mp, Pp) of the span, from its filtered moments and carry."""
    if sf.mp is not None:
        return sf.mp, sf.Pp
    A, Q, m, P = lgssm.A.to(sf.P.dtype), lgssm.Q.to(sf.P.dtype), sf.m, sf.P
    m0 = m.new_zeros((1,) + m.shape[1:]) if sf.init is None else sf.init[0][None]
    P0 = P.new_zeros((1,) + P.shape[1:]) if sf.init is None else sf.init[1][None]
    m_prev, P_prev = torch.cat([m0, m[:-1]]), torch.cat([P0, P[:-1]])
    return A @ m_prev, A @ P_prev @ A.transpose(-1, -2) + Q


def span_suffix(ax: TimeAxis, E, g, L, kernels: bool):
    """The suffix recursions v_k = g_k + E_k v_{k+1}, M_k = L_k + E_k M_{k+1}
    E_k^T over this rank's span, continued into the later ranks' spans.
    Returns (v (n, d, C), M (n, d, d), terminal), terminal the state after
    the span (None on the last rank).  On the kernels: K4a per block, the
    blocks folded, the carry, K4b; else the tensor-code blocked scan with the
    carry applied after it."""
    if kernels:
        from gpar_at_scale_torch.ops.smoother import (
            block_suffix_inits,
            suffix_reduce,
            suffix_replay,
        )

        E, g, L = (x.contiguous() for x in (E, g, L))
        n = E.shape[0]
        nb = num_blocks_for(n)
        T = -(-n // nb)
        blocks = suffix_reduce(E, g, L, nb, T)
        terminal = _carry_back(ax, blocks, E.dtype)
        v, M = suffix_replay(E, g, L, *block_suffix_inits(*blocks, terminal), nb, T)
        return v, M, terminal
    Es, gs, Ls = blocked_suffix_scan(E, g, L)
    terminal = _carry_back(ax, (Es[:1], gs[:1], Ls[:1]), E.dtype)
    if terminal is not None:
        gs = gs + Es @ terminal[0]
        Ls = Ls + Es @ terminal[1] @ Es.transpose(-1, -2)
    return gs, Ls, terminal


def span_backward(ax: TimeAxis, A, H, sf: SpanFilter, A_after, ct_G, ct_ld):
    """(ct_A, ct_Q, ct_R, ct_U) of the span from the Gram cotangents: the
    adjoint elements (``whiten_bwd_elements``, whose last step crosses to
    ``A_after``, the next span's first transition), the suffix scan across
    the ranks, and the scores with the carries on both sides."""
    kernels = A.dtype == _F32 and sf.mp is None
    aux = (sf.alpha * torch.sqrt(sf.S)[:, None], sf.S, sf.K, sf.m, sf.P)
    C, b, W = whiten_bwd_elements(A, H, aux, A_after)
    r, Nmat, terminal = span_suffix(ax, C, b, W, kernels)
    after = None if terminal is None else (A_after, terminal[0], terminal[1])
    return whiten_bwd_scores(A, H, aux, r, Nmat, ct_G, ct_ld, before=sf.init, after=after)


# ---------------------------------------------------------------------------
# Autograd: the span cut and the sharded Gram
# ---------------------------------------------------------------------------


class _Span(torch.autograd.Function):
    """x[start:start + length] of a tensor every rank holds whole; the
    backward all-gathers the spans' cotangents, so every rank gets the
    whole cotangent."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x[ax.start:ax.start + ax.length].clone()

    @staticmethod
    def backward(ctx, ct):
        return all_gather_rows(ct.contiguous(), ctx.ax.counts, ctx.ax.group), None


def _span_of(x, ax: TimeAxis):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Span.apply(x, ax)
    return x[ax.start:ax.start + ax.length]


class ShardedWhiten(torch.autograd.Function):
    """(G (B, B), log det Sigma, ll (B,)), each summed over the ranks in
    float64, of this rank's span: A, Q (n, d, d), R (n,), U (n, B) of the
    span, ``A_after`` the transition of the step after it (None on the
    last rank).  Differentiable in (A, Q, R, U): the backward gives the
    span's own cotangents (``span_backward``), with the cotangent of ll
    folded into the Gram's (ll = -(n log 2 pi + log det + diag G) / 2)."""

    @staticmethod
    def forward(ctx, A, Q, R, U, A_after, H, ax, e1):
        lg = LGSSM(A=A, Q=Q, H=H, R=R, e1=e1)
        sf = span_filter(ax, lg, U, moments=True)
        W = sf.alpha.double()
        B = W.shape[1]
        packed = torch.cat([(W.T @ W).reshape(-1), torch.log(sf.S).double().sum()[None], sf.ll])
        packed = all_reduce_sum(packed, ax.group)
        ctx.ax, ctx.sf = ax, sf
        ctx.save_for_backward(A, H, A_after)
        return packed[:B * B].reshape(B, B).clone(), packed[B * B].clone(), packed[B * B + 1:].clone()

    @staticmethod
    def backward(ctx, ct_G, ct_ld, ct_ll):
        A, H, A_after = ctx.saved_tensors
        ct_G = ct_G - 0.5 * torch.diag(ct_ll)
        ct_ld = ct_ld - 0.5 * ct_ll.sum()
        dA, dQ, dR, dU = span_backward(ctx.ax, A, H.to(A.dtype), ctx.sf, A_after, ct_G, ct_ld)
        return dA, dQ, dR, dU, None, None, None, None


def _whiten_span(ax: TimeAxis, lgssm: LGSSM, U, full: bool):
    """``ShardedWhiten`` of this rank's span.  ``full``: every rank passes
    the whole series (A, Q, R, U are cut to the span with ``_Span``, so the
    cotangents come back whole); else they are the span's already, and
    ``lgssm`` carries the step after it as its last row on every rank but
    the last."""
    dtype = lgssm.A.dtype
    n = lgssm.num_steps
    R = lgssm.R.to(dtype).expand(n)
    U = U.to(dtype)
    if full:
        e = ax.start + ax.length
        parts = [_span_of(x, ax) for x in (lgssm.A, lgssm.Q, R, U)]
        A_after = None if ax.last else lgssm.A[e].detach()
    else:
        ln = U.shape[0]
        parts = [lgssm.A[:ln], lgssm.Q[:ln], R[:ln], U]
        A_after = None if ax.last else lgssm.A[ln].detach()
    return ShardedWhiten.apply(*parts, A_after, lgssm.H.to(dtype), ax, lgssm.e1)


# ---------------------------------------------------------------------------
# The whole-series functions
# ---------------------------------------------------------------------------


def _forward_only(name, lgssm: LGSSM, y):
    if torch.is_grad_enabled() and any(
            torch.is_tensor(x) and x.requires_grad for x in (lgssm.A, lgssm.Q, lgssm.R, y)):
        raise RuntimeError(
            f"{name} is forward only (its moments come from the kernels and the collectives, "
            "with no backward); take gradients through logpdf or gram")


class ShardedFilter:
    """The time-sharded engines over ``mesh[axis]``; calling it is the
    filter, ``filter_fn(lgssm, y) -> FilterResult``."""

    def __init__(self, mesh, axis: str = "data"):
        self.mesh, self.axis = mesh, axis

    def _prep(self, lgssm: LGSSM, y):
        Y, single = _ensure_batch(torch.as_tensor(y, device=lgssm.A.device))
        ax = time_axis(self.mesh, self.axis, lgssm.num_steps)
        s, ln = ax.start, ax.length
        R = lgssm.R.expand(lgssm.num_steps)
        lg = LGSSM(A=lgssm.A[s:s + ln], Q=lgssm.Q[s:s + ln], H=lgssm.H, R=R[s:s + ln], e1=lgssm.e1)
        return ax, lg, Y.to(lgssm.A.dtype)[s:s + ln], single

    def _rows(self, ax: TimeAxis, x):
        return all_gather_rows(x.contiguous(), ax.counts, ax.group)

    def _ll(self, ax: TimeAxis, sf: SpanFilter, dtype):
        return all_reduce_sum(sf.ll, ax.group).to(dtype)

    def __call__(self, lgssm: LGSSM, y) -> FilterResult:
        """``FilterResult`` of the whole series (``kalman_filter``'s
        contract), every rank the whole of it.  Forward only."""
        _forward_only("the sharded filter", lgssm, y)
        ax, lg, Y, _ = self._prep(lgssm, y)
        sf = span_filter(ax, lg, Y, moments=True)
        mp, Pp = _predicted(lg, sf)
        v = sf.alpha * torch.sqrt(sf.S)[:, None] if sf.v is None else sf.v
        rows = [self._rows(ax, x) for x in (sf.m, sf.P, mp, Pp, sf.S, v)]
        return FilterResult(*rows, ll=self._ll(ax, sf, lgssm.A.dtype))

    def decorrelate(self, lgssm: LGSSM, y):
        """(ll, alpha = v / sqrt(S)) of the whole series, without moments
        (``ops.kalman.decorrelate_blocked`` and ``ssm.kalman.decorrelate``).
        Forward only."""
        _forward_only("the sharded decorrelate", lgssm, y)
        ax, lg, Y, single = self._prep(lgssm, y)
        sf = span_filter(ax, lg, Y, moments=False)
        ll, alpha = self._ll(ax, sf, lgssm.A.dtype), self._rows(ax, sf.alpha)
        return (ll[0], alpha[:, 0]) if single else (ll, alpha)

    def smooth(self, lgssm: LGSSM, y) -> SmoothResult:
        """``SmoothResult`` of the whole series (``rts_smooth``'s contract):
        the span filter, then the smoothing elements (the last one toward the
        next span's first step, predicted here from the span's last filtered
        moments), then the suffix scan across the ranks.  Forward only."""
        _forward_only("the sharded smoother", lgssm, y)
        from gpar_at_scale_torch.ssm.segmented import _next_step

        ax, lg, Y, single = self._prep(lgssm, y)
        sf = span_filter(ax, lg, Y, moments=True)
        nxt = None
        if not ax.last:
            e = ax.start + ax.length
            step = LGSSM(A=lgssm.A[e:e + 1], Q=lgssm.Q[e:e + 1], H=lgssm.H, R=lgssm.R)
            nxt = _next_step(step, (sf.m[-1], sf.P[-1]))
        kernels = sf.mp is None
        if kernels:
            parts = [smoothing_elements(lg, sf.m[:, :, c], sf.P, next_step=None if nxt is None
                                        else (nxt[0], nxt[1][:, c], nxt[2]))
                     for c in range(sf.m.shape[2])]
            E, g, L = parts[0][0], torch.stack([p[1] for p in parts], -1), parts[0][2]
        else:
            mp, Pp = _predicted(lg, sf)
            res = FilterResult(m=sf.m, P=sf.P, mp=mp, Pp=Pp, S=sf.S, v=sf.v, ll=sf.ll)
            E, g, L = _smoother_elements(lg, res, nxt)
        ms, Ps, _ = span_suffix(ax, E, g, L, kernels)
        ms, Ps = self._rows(ax, ms), self._rows(ax, Ps)
        H = lgssm.H.to(ms.dtype)
        mean = torch.einsum("d,ndb->nb", H, ms)
        var = torch.clamp(torch.einsum("d,nde,e->n", H, Ps, H), min=0.0)
        return SmoothResult(mean=mean[:, 0] if single else mean, var=var,
                            ll=self._ll(ax, sf, lgssm.A.dtype), ms=ms, Ps=Ps)

    def logpdf(self, lgssm: LGSSM, y):
        """log N(y | 0, Sigma) per column (a scalar for one series),
        differentiable in the LGSSM and y.  On an axis of one rank, the
        unsharded closed-form engines: ``ops.grad.lgssm_loglik`` on the
        kernels, ``ssm.blocked_grad.blocked_loglik`` else."""
        y = torch.as_tensor(y, device=lgssm.A.device)
        ax = time_axis(self.mesh, self.axis, lgssm.num_steps)
        if ax.size == 1 and y.ndim == 1:
            if _on_kernels(lgssm):
                from gpar_at_scale_torch.ops.grad import lgssm_loglik

                return lgssm_loglik(lgssm.A, lgssm.Q, lgssm.R.expand(lgssm.num_steps), y)
            from gpar_at_scale_torch.ssm.blocked_grad import blocked_loglik

            return blocked_loglik(lgssm, y)
        Y, single = _ensure_batch(y)
        ll = _whiten_span(ax, lgssm, Y, full=True)[2].to(lgssm.A.dtype)
        return ll[0] if single else ll

    def gram(self, lgssm: LGSSM, U):
        """(G = U^T Sigma^-1 U, log det Sigma) in float64, differentiable in
        the LGSSM and U: ``gp/dtc.py``'s Gram through this engine.  On an
        axis of one rank, the unsharded engines: ``ops.whiten.whiten_gram``
        on the kernels, ``ssm.blocked_grad.whiten_gram`` else."""
        ax = time_axis(self.mesh, self.axis, lgssm.num_steps)
        if ax.size == 1:
            if _on_kernels(lgssm):
                from gpar_at_scale_torch.ops.whiten import whiten_gram
            else:
                from gpar_at_scale_torch.ssm.blocked_grad import whiten_gram
            return whiten_gram(lgssm, U)
        G, logdet, _ = _whiten_span(ax, lgssm, torch.as_tensor(U, device=lgssm.A.device), full=True)
        return G, logdet


def make_sharded_filter(mesh, axis: str = "data") -> ShardedFilter:
    """``filter_fn(lgssm, y) -> FilterResult`` through the time-sharded
    filter over ``mesh[axis]``; a drop-in for ``gp/dtc.py``'s ``filter_fn``
    (the Gram then goes through ``ShardedFilter.gram``)."""
    return ShardedFilter(mesh, axis)


def make_sharded_decorrelate(mesh, axis: str = "data"):
    """(ll, alpha) through the time-sharded filter: ``ShardedFilter.decorrelate``."""
    return ShardedFilter(mesh, axis).decorrelate


def make_sharded_logpdf(mesh, axis: str = "data"):
    """Differentiable log-likelihood through the time-sharded filter:
    ``ShardedFilter.logpdf``."""
    return ShardedFilter(mesh, axis).logpdf


def make_sharded_smooth(mesh, axis: str = "data"):
    """Time-sharded RTS smoother: ``ShardedFilter.smooth``."""
    return ShardedFilter(mesh, axis).smooth
