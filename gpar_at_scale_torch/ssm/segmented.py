"""Segmented (streaming) execution of the blocked engines, with exact carries.

Counterpart of ``gpar_at_scale_tpu/ssm/segmented.py``.  The series runs
through the card in segments of at most ``segment_size`` steps, one after
the other, and only one segment's working arrays plus the carries across a
seam are live at a time:

* filter: the previous segment's last filtered (m, P) enters the next
  segment's phase-2 prefix (``blocked_filter(init=...)``,
  ``ops.kalman.decorrelate_blocked(init=...)``); the innovations
  decomposition makes the per-segment log-likelihoods add up, and they are
  summed in float64;
* smoother, gradient, draws: a reverse loop over the segments carries the
  later segment's first step (its transition and predicted moments, and its
  smoothed moments, adjoints or draw) into the suffix scan's terminal
  element (``blocked_smooth(boundary=...)``, ``blocked_suffix_scan(
  terminal=...)``, ``ops.smoother.suffix_scan(terminal)``).

Segmented equals fused up to rounding (the same per-step quantities).

Route, per segment: one float32 observation column of an SDE the scan
kernels take (``ops.kalman.pallas_supported``: d <= 3, H = e1) runs on
K1/K2 forward and K4a/K4b backward; every other segment (float64, several
columns, sum kernels) runs the tensor-code blocked engine, which is the
JAX package's only route.  The ``_t`` variants and ``make_segmented_nll_grad``
discretize each segment on its own from the time grid, so no full-length
(N, d, d) array exists; a continuation segment is discretized with its left
neighbour's time and drops that row, so its first transition is the real
one across the seam.  Segments of the kernel route keep their filtered and
predicted moments in float32: about 100 bytes a step, 1 GB at N = 10^7.
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ssm.blocked import (
    blocked_filter,
    blocked_smooth,
    blocked_suffix_scan,
    sample_from_moments,
)
from gpar_at_scale_torch.ssm.blocked_grad import whiten_bwd_elements, whiten_bwd_scores
from gpar_at_scale_torch.ssm.kalman import FilterResult, SmoothResult, _ensure_batch
from gpar_at_scale_torch.ssm.markov import LGSSM, lgssm_of

# Steps per segment, from the card's peak memory per segment (H100 80GB
# HBM3, 700 W; chip_smoke.py, [segmented]): the float32 gradient of a
# Matern-5/2 likelihood (``make_segmented_nll_grad``) peaks at 0.97 GiB for
# one segment of 10^6 steps and at 7.54 GiB for one of 10^7, which is also
# the faster (0.27 s a gradient for N = 10^7 against 0.52 s in segments of
# 10^6: fewer launches); each segment kept for the backward holds about
# 0.1 GiB per 10^6 steps.  Segments of 10^7 take a tenth of the card, and a
# series of 10^8 steps then needs about 18 GiB.
SEGMENT_SIZE = 10_000_000


def _seg_bounds(n, segment_size):
    """[(start, length)] of the segments of an n-step series."""
    seg = max(1, min(segment_size, n))
    return [(s, min(seg, n - s)) for s in range(0, n, seg)]


def _on_kernels(lgssm: LGSSM, columns: int) -> bool:
    """Whether a segment runs on the scan kernels: one float32 column of an
    SDE they take."""
    from gpar_at_scale_torch.ops.kalman import pallas_supported

    return columns == 1 and lgssm.A.dtype == torch.float32 and pallas_supported(lgssm)


def _slice(lgssm: LGSSM, s, ln) -> LGSSM:
    R = lgssm.R.expand(lgssm.num_steps)
    return LGSSM(A=lgssm.A[s:s + ln], Q=lgssm.Q[s:s + ln], H=lgssm.H, R=R[s:s + ln],
                 e1=lgssm.e1)


def _lg_seg(kernel, t_ext, noise_var, first, dtype) -> LGSSM:
    """Discretize one segment.  A continuation segment's t_ext (and a
    per-point noise_var) carry the left neighbour's point, whose prior row
    is dropped."""
    lg = lgssm_of(kernel, t_ext, noise_var, dtype)
    if first:
        return lg
    return LGSSM(A=lg.A[1:], Q=lg.Q[1:], H=lg.H, R=lg.R[1:], e1=lg.e1)


def _ext(x, s, ln):
    """A segment's slice of a per-step array, with the left neighbour's row
    for a continuation segment."""
    return x[s:s + ln] if s == 0 else x[s - 1:s + ln]


def _filter_piece(lgssm: LGSSM, Y, num_blocks, init) -> FilterResult:
    """One segment's ``FilterResult`` given the filtered carry ``init``
    (m (d, C), P (d, d)) of the step before it, or None for the first."""
    if not _on_kernels(lgssm, Y.shape[1]):
        return blocked_filter(lgssm, Y, num_blocks, init=init)
    from gpar_at_scale_torch.ops.kalman import decorrelate_blocked

    ll, alpha, _, S, _, m, P = decorrelate_blocked(
        lgssm, Y[:, 0], num_blocks, return_full=True,
        init=None if init is None else (init[0][:, 0], init[1]),
    )
    A, Q = lgssm.A, lgssm.Q
    m0 = m.new_zeros((1, m.shape[1])) if init is None else init[0].reshape(1, -1)
    P0 = P.new_zeros((1,) + P.shape[1:]) if init is None else init[1][None]
    m_prev, P_prev = torch.cat([m0, m[:-1]]), torch.cat([P0, P[:-1]])
    return FilterResult(
        m=m[:, :, None], P=P, mp=A @ m_prev[:, :, None],
        Pp=A @ P_prev @ A.transpose(-1, -2) + Q, S=S, v=(alpha * torch.sqrt(S))[:, None],
        ll=ll.reshape(1),
    )


def _filter_pass(lg_of, bounds, Y, num_blocks, keep=None):
    """Filter the segments in order, each from the carry of the one before;
    returns ``keep(piece)`` (the piece itself if None) per segment."""
    out, init = [], None
    for k, (s, ln) in enumerate(bounds):
        piece = _filter_piece(lg_of(k), Y[s:s + ln], num_blocks, init)
        init = (piece.m[-1], piece.P[-1])
        out.append(piece if keep is None else keep(piece))
    return out


def _sum_ll(lls):
    return sum(ll.double() for ll in lls)


def _cat_filter(pieces) -> FilterResult:
    cat = lambda name: torch.cat([getattr(p, name) for p in pieces])  # noqa: E731
    return FilterResult(m=cat("m"), P=cat("P"), mp=cat("mp"), Pp=cat("Pp"), S=cat("S"),
                        v=cat("v"), ll=_sum_ll(p.ll for p in pieces))


def _whitened(piece):
    return piece.ll, piece.v / torch.sqrt(piece.S)[:, None]


def _decorrelate_out(parts, single):
    ll = _sum_ll(p[0] for p in parts)
    alpha = torch.cat([p[1] for p in parts])
    return (ll[0], alpha[:, 0]) if single else (ll, alpha)


def segmented_filter(lgssm: LGSSM, y, segment_size: int = SEGMENT_SIZE, num_blocks=None):
    """Forward filter in segments: the ``FilterResult`` of ``blocked_filter``
    and ``kalman_filter`` (batched columns too), ll summed in float64."""
    Y, _ = _ensure_batch(y)
    Y = Y.to(lgssm.A.dtype)
    bounds = _seg_bounds(lgssm.num_steps, segment_size)
    return _cat_filter(_filter_pass(lambda k: _slice(lgssm, *bounds[k]), bounds, Y, num_blocks))


def segmented_logpdf(lgssm: LGSSM, y, segment_size: int = SEGMENT_SIZE, num_blocks=None):
    """log N(y | 0, Sigma) per column, in float64, through the segmented
    filter; only each segment's ll is kept."""
    Y, single = _ensure_batch(y)
    bounds = _seg_bounds(lgssm.num_steps, segment_size)
    ll = _sum_ll(_filter_pass(lambda k: _slice(lgssm, *bounds[k]), bounds,
                              Y.to(lgssm.A.dtype), num_blocks, keep=lambda p: p.ll))
    return ll[0] if single else ll


def segmented_decorrelate(lgssm: LGSSM, y, segment_size: int = SEGMENT_SIZE, num_blocks=None):
    """Whitening pass (ll, alpha) in segments: each segment keeps only its
    ll and alpha = v / sqrt(S), no moments."""
    Y, single = _ensure_batch(y)
    bounds = _seg_bounds(lgssm.num_steps, segment_size)
    parts = _filter_pass(lambda k: _slice(lgssm, *bounds[k]), bounds, Y.to(lgssm.A.dtype),
                         num_blocks, keep=_whitened)
    return _decorrelate_out(parts, single)


# ---------------------------------------------------------------------------
# Backward passes: the step after each segment
# ---------------------------------------------------------------------------


def _carry(piece):
    return piece.m[-1], piece.P[-1]


def _next_step(lgssm: LGSSM, carry):
    """(A1, mp1 (d, C), Pp1) of a segment's first step, predicted from the
    filtered ``carry`` of the segment before it, in float64: the FFBS
    elements at the seam then cancel in float64, as inside a segment
    (``ssm.blocked.ffbs_elements``)."""
    A1, Q1 = lgssm.A[0].double(), lgssm.Q[0].double()
    m, P = (x.double() for x in carry)
    return A1, A1 @ m, A1 @ P @ A1.T + Q1


def _smooth_piece(lgssm: LGSSM, Y, piece, boundary, num_blocks) -> SmoothResult:
    if not _on_kernels(lgssm, Y.shape[1]):
        return blocked_smooth(lgssm, Y, filter_result=piece, num_blocks=num_blocks,
                              boundary=boundary)
    from gpar_at_scale_torch.ops.smoother import smooth_moments

    ms, Ps, _ = smooth_moments(lgssm, piece.m[:, :, 0], piece.P, boundary)
    return SmoothResult(mean=ms[:, :1], var=torch.clamp(Ps[:, 0, 0], min=0.0), ll=piece.ll,
                        ms=ms[:, :, None], Ps=Ps)


def _smooth_pass(lg_of, bounds, Y, pieces, num_blocks, single) -> SmoothResult:
    """The reverse loop of the smoother: each segment from the first
    smoothed step of the one after it."""
    outs, boundary = [None] * len(bounds), None
    for k in range(len(bounds) - 1, -1, -1):
        s, ln = bounds[k]
        lg = lg_of(k)
        sm = _smooth_piece(lg, Y[s:s + ln], pieces[k], boundary, num_blocks)
        outs[k] = sm
        if k > 0:
            boundary = _next_step(lg, _carry(pieces[k - 1])) + (sm.ms[0], sm.Ps[0])
    cat = lambda name: torch.cat([getattr(o, name) for o in outs])  # noqa: E731
    mean = cat("mean")
    return SmoothResult(mean=mean[:, 0] if single else mean, var=cat("var"),
                        ll=_sum_ll(p.ll for p in pieces), ms=cat("ms"), Ps=cat("Ps"))


def segmented_smooth(lgssm: LGSSM, y, segment_size: int = SEGMENT_SIZE, num_blocks=None
                     ) -> SmoothResult:
    """RTS smoother in segments: the segmented filter, then a reverse loop
    with the later segment's first smoothed step as the terminal element.
    ``SmoothResult`` parity with ``blocked_smooth`` and ``rts_smooth``."""
    Y, single = _ensure_batch(y)
    Y = Y.to(lgssm.A.dtype)
    bounds = _seg_bounds(lgssm.num_steps, segment_size)
    lg_of = lambda k: _slice(lgssm, *bounds[k])  # noqa: E731
    pieces = _filter_pass(lg_of, bounds, Y, num_blocks)
    return _smooth_pass(lg_of, bounds, Y, pieces, num_blocks, single)


def _seg_bwd(lgssm: LGSSM, piece, before, after, num_blocks):
    """One segment's loglik cotangents (dA, dQ, dR, dy) and its first step's
    adjoints (r0 (d, 1), N0 (d, d)): the disturbance smoother of
    ``ssm.blocked_grad.loglik_bwd`` with the carries ``before`` (the
    filtered (m, P) before the segment) and ``after`` (A, r, N of the step
    after it: the suffix scan's terminal element); None at the series'
    ends."""
    A = lgssm.A
    H = lgssm.H.to(A.dtype)
    K = torch.einsum("nij,j->ni", piece.Pp, H) / piece.S[:, None]
    aux = (piece.v, piece.S, K, piece.m, piece.P)
    C, b, W = whiten_bwd_elements(A, H, aux, None if after is None else after[0])
    terminal = None if after is None else after[1:]
    if _on_kernels(lgssm, 1):
        from gpar_at_scale_torch.ops.smoother import suffix_scan

        r, Nmat = suffix_scan(C, b, W, terminal)
    else:
        _, r, Nmat = blocked_suffix_scan(C, b, W, num_blocks, terminal)
    half = torch.full((1, 1), -0.5, dtype=A.dtype, device=A.device)
    dA, dQ, dR, dU = whiten_bwd_scores(A, H, aux, r, Nmat, half, -0.5, before, after)
    return dA, dQ, dR, dU[:, 0], r[0], Nmat[0]


def segmented_loglik_grad(lgssm: LGSSM, y, segment_size: int = SEGMENT_SIZE, num_blocks=None):
    """(ll, dA, dQ, dR, dy) of log N(y | 0, Sigma) for one observation column:
    the closed-form gradient of ``ssm.blocked_grad.loglik_bwd`` in segments,
    the r/N adjoints carried backward across each seam with the next
    segment's first transition.  ll in float64."""
    y = torch.as_tensor(y, device=lgssm.A.device).to(lgssm.A.dtype)
    bounds = _seg_bounds(lgssm.num_steps, segment_size)
    lg_of = lambda k: _slice(lgssm, *bounds[k])  # noqa: E731
    pieces = _filter_pass(lg_of, bounds, y[:, None], num_blocks)
    outs, after = [None] * len(bounds), None
    for k in range(len(bounds) - 1, -1, -1):
        lg = lg_of(k)
        before = None if k == 0 else _carry(pieces[k - 1])
        dA, dQ, dR, dy, r0, N0 = _seg_bwd(lg, pieces[k], before, after, num_blocks)
        outs[k] = (dA, dQ, dR, dy)
        after = (lg.A[0], r0, N0)
    cat = lambda i: torch.cat([o[i] for o in outs])  # noqa: E731
    return (_sum_ll(p.ll for p in pieces)[0],) + tuple(cat(i) for i in range(4))


# ---------------------------------------------------------------------------
# Time-parameterised variants: each segment discretized on its own
# ---------------------------------------------------------------------------


def _t_prep(t, noise_var, y, dtype):
    t = torch.as_tensor(t)
    dtype = dtype or t.dtype
    Y, single = _ensure_batch(torch.as_tensor(y, device=t.device))
    n = t.shape[0]
    nv = torch.as_tensor(noise_var, dtype=t.dtype, device=t.device).expand(n)
    return t, nv, Y.to(dtype), n, single, dtype


def _t_lg_of(kernel, t, nv, bounds, dtype):
    def lg_of(k):
        s, ln = bounds[k]
        return _lg_seg(kernel, _ext(t, s, ln), _ext(nv, s, ln), s == 0, dtype)

    return lg_of


def segmented_filter_t(kernel, t, noise_var, y, segment_size: int = SEGMENT_SIZE,
                       num_blocks=None, dtype=None) -> FilterResult:
    """``segmented_filter`` from a Markovian kernel, sorted times t and noise
    (scalar or (N,)): each segment is discretized on its own, in t's
    precision, then cast to ``dtype`` (t's by default), so no full-length
    (N, d, d) array exists before the filter."""
    t, nv, Y, n, _, dtype = _t_prep(t, noise_var, y, dtype)
    bounds = _seg_bounds(n, segment_size)
    return _cat_filter(_filter_pass(_t_lg_of(kernel, t, nv, bounds, dtype), bounds, Y,
                                    num_blocks))


def segmented_decorrelate_t(kernel, t, noise_var, y, segment_size: int = SEGMENT_SIZE,
                            num_blocks=None, dtype=None):
    """``segmented_decorrelate`` with per-segment discretization."""
    t, nv, Y, n, single, dtype = _t_prep(t, noise_var, y, dtype)
    bounds = _seg_bounds(n, segment_size)
    parts = _filter_pass(_t_lg_of(kernel, t, nv, bounds, dtype), bounds, Y, num_blocks,
                         keep=_whitened)
    return _decorrelate_out(parts, single)


def segmented_smooth_t(kernel, t, noise_var, y, segment_size: int = SEGMENT_SIZE,
                       num_blocks=None, dtype=None) -> SmoothResult:
    """``segmented_smooth`` with per-segment discretization (each segment
    discretized again in the reverse loop)."""
    t, nv, Y, n, single, dtype = _t_prep(t, noise_var, y, dtype)
    bounds = _seg_bounds(n, segment_size)
    lg_of = _t_lg_of(kernel, t, nv, bounds, dtype)
    pieces = _filter_pass(lg_of, bounds, Y, num_blocks)
    return _smooth_pass(lg_of, bounds, Y, pieces, num_blocks, single)


def make_segmented_nll_grad(kernel_fn, t, y, segment_size: int = SEGMENT_SIZE,
                            num_blocks=None, dtype=None):
    """Closed-form log-likelihood gradient in segments, every array
    segment-sized.  ``kernel_fn``: p -> (Markovian kernel, noise variance).
    Returns ``grad_fn(p) -> (ll, g)``, ll in float64 and g = d ll / d p in
    p's dtype (summed over the segments in float64).

    Per segment the forward pass discretizes (without autograd) and filters
    from the carry; the reverse loop discretizes again under autograd, runs
    the segment's r/N adjoints (``segmented_loglik_grad``'s), and pulls
    (dA, dQ, dR) back into p through that segment's own discretization
    (``torch.autograd.grad`` with them as ``grad_outputs``).  Transitions
    depend only on local gaps, so the per-segment pullbacks with the left
    neighbour's point add up to the whole series' gradient.  The
    discretization runs in t's precision (give t in float64), then casts to
    ``dtype`` (t's by default); the scans run in ``dtype``."""
    t = torch.as_tensor(t)
    dtype = dtype or t.dtype
    y = torch.as_tensor(y, device=t.device).to(dtype)[:, None]
    bounds = _seg_bounds(t.shape[0], segment_size)

    def lg_of(p, k):
        s, ln = bounds[k]
        kernel, nv = kernel_fn(p)
        return _lg_seg(kernel, _ext(t, s, ln), nv, s == 0, dtype)

    def grad_fn(p):
        p = torch.as_tensor(p)
        with torch.no_grad():
            pieces = _filter_pass(lambda k: lg_of(p, k), bounds, y, num_blocks)
        g, after = None, None
        for k in range(len(bounds) - 1, -1, -1):
            pk = p.detach().requires_grad_(True)
            with torch.enable_grad():
                lg = lg_of(pk, k)
            plain = LGSSM(A=lg.A.detach(), Q=lg.Q.detach(), H=lg.H.detach(),
                          R=lg.R.detach(), e1=lg.e1)
            with torch.no_grad():
                before = None if k == 0 else _carry(pieces[k - 1])
                dA, dQ, dR, _, r0, N0 = _seg_bwd(plain, pieces[k], before, after, num_blocks)
            outs = [(o, c) for o, c in zip((lg.A, lg.Q, lg.R), (dA, dQ, dR)) if o.requires_grad]
            (gs,) = torch.autograd.grad([o for o, _ in outs], pk, [c for _, c in outs])
            g = gs.double() if g is None else g + gs.double()
            after = (plain.A[0], r0, N0)
        return _sum_ll(pc.ll for pc in pieces)[0], g.to(p.dtype)

    return grad_fn


# ---------------------------------------------------------------------------
# Posterior draws (FFBS) in segments
# ---------------------------------------------------------------------------


def segmented_posterior_sample(generator: torch.Generator, lgssm: LGSSM, y,
                               num_samples: int = 1, segment_size: int = SEGMENT_SIZE,
                               num_blocks=None, xi=None):
    """Joint posterior draws of f = H x given one observation column, in
    segments: the segmented filter, then a reverse loop where each segment's
    last FFBS conditional crosses to the later segment's first step
    (``next_step``) and its first draw is the affine scan's terminal element
    (``x_term``).  Given the same ``xi`` (N, d, num_samples) standard normals
    it is ``blocked_posterior_sample``'s draw; else they come from
    ``generator``, on its device.  Returns (num_samples, N)."""
    Y, _ = _ensure_batch(y)
    if Y.shape[1] != 1:
        raise ValueError("segmented_posterior_sample expects one observation column")
    n, d = lgssm.num_steps, lgssm.dim
    dtype, dev = lgssm.A.dtype, lgssm.A.device
    bounds = _seg_bounds(n, segment_size)
    lg_of = lambda k: _slice(lgssm, *bounds[k])  # noqa: E731
    pieces = _filter_pass(lg_of, bounds, Y.to(dtype), num_blocks)
    if xi is None:
        xi = torch.randn((n, d, num_samples), generator=generator, dtype=dtype,
                         device=generator.device)
    xi = torch.as_tensor(xi).to(device=dev, dtype=dtype)

    outs, next_step, x_term = [None] * len(bounds), None, None
    for k in range(len(bounds) - 1, -1, -1):
        s, ln = bounds[k]
        lg = lg_of(k)
        m, P = pieces[k].m[:, :, 0], pieces[k].P
        if _on_kernels(lg, 1):
            from gpar_at_scale_torch.ops.smoother import draw_states

            x = draw_states(lg, m, P, xi[s:s + ln], next_step, x_term)
        else:
            x = sample_from_moments(lg, m, P, xi[s:s + ln], num_blocks, next_step, x_term)
        outs[k] = x
        if k > 0:
            next_step, x_term = _next_step(lg, _carry(pieces[k - 1])), x[0]
    return torch.einsum("d,nds->sn", lgssm.H.to(dtype), torch.cat(outs))
