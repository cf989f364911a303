"""Blocked two-pass Kalman filter and RTS smoother as tensor code.

Counterpart of ``gpar_at_scale_tpu/ssm/blocked.py``: split the N-step series
into B contiguous blocks, reduce each block's filtering elements in lockstep
(a Python loop over T = ceil(N / B) steps, each step batched over all B
blocks), take an associative prefix over the B block totals, then replay
each block from its known filtered init.  The smoother is the same schedule
in reverse over the (E, g, L) smoothing elements.  It is the large-N
smoother of ``predict_scaled`` and of the first output's predictive.
Posterior draws by FFBS (``blocked_posterior_sample``) run the affine half
of that reverse scan over pre-drawn noises.

On the card every loop iteration is a handful of small launches, so the
block count is set for the GPU (``NUM_BLOCKS``): enough blocks that T stays
short, few enough that the prefix over block totals (log2 B levels) stays
cheap.  The CUDA scan kernels (``ops/kalman.py``) use the same block count,
and the three phases of ``blocked_filter`` (``block_totals``,
``block_inits``, ``replay_blocks``) are their plain versions.

A segment of a longer series (``ssm/segmented.py``) takes carries across
its seams: the filtered state before it enters phase 2
(``blocked_filter(init=)``), and the step after it ends the reverse scans
(``blocked_suffix_scan(terminal=)``, ``blocked_smooth(boundary=)``,
``next_step`` and ``x_term`` of the FFBS elements and draws).
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ssm.kalman import FilterResult, SmoothResult, _ensure_batch
from gpar_at_scale_torch.ssm.markov import LGSSM
from gpar_at_scale_torch.ssm.pkalman import (
    _combine_fast,
    _combine_smooth,
    _filter_elements,
    _inv_small,
    _scan,
    _smoother_elements,
)

_LOG_2PI = 1.8378770664093453

# Largest block count: T = ceil(N / B) loop iterations against log2(B) prefix
# levels.  At N = 1e6, 16384 blocks give T = 62.
NUM_BLOCKS = 16384
# Fewest steps a block gets when N is small, so short series still run the
# blocked schedule instead of degenerating into the prefix alone.
MIN_BLOCK_STEPS = 16


def num_blocks_for(n: int, num_blocks=None) -> int:
    """Block count for an n-step series: ``num_blocks`` if given, else
    min(NUM_BLOCKS, n // MIN_BLOCK_STEPS); always in [1, n]."""
    if num_blocks is None:
        num_blocks = min(NUM_BLOCKS, n // MIN_BLOCK_STEPS)
    return max(1, min(int(num_blocks), n))


def _elem_identity(B, d, C, dtype, device):
    """Identity of the filtering-element monoid, repeated over B blocks."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    eye = torch.eye(d, dtype=dtype, device=device).expand(B, d, d)
    return (eye, z(B, d, C), z(B, d, d), z(B, d, C), z(B, d, d))


def _block(x, B, T):
    """(B*T, ...) -> (T, B, ...): block b owns the contiguous steps
    [b*T, (b+1)*T); index t walks every block's local step in lockstep."""
    return x.reshape((B, T) + x.shape[1:]).transpose(0, 1)


def _unblock(x, n):
    """(T, B, ...) -> (B*T, ...)[:n]."""
    T, B = x.shape[:2]
    return x.transpose(0, 1).reshape((B * T,) + x.shape[2:])[:n]


def _pad_block(x, B, T, fill):
    """Pad (n, ...) to B*T rows equal to ``fill`` (broadcast to a row of x)
    and block it to (T, B, ...)."""
    pad = B * T - x.shape[0]
    if pad:
        rows = torch.as_tensor(fill, dtype=x.dtype, device=x.device).expand((pad,) + x.shape[1:])
        x = torch.cat([x, rows], dim=0)
    return _block(x, B, T)


def block_totals(lgssm: LGSSM, Y, B, T):
    """Phase 1: each block's filtering elements folded into one block
    element (A, b, C, eta, J), b and eta (B, d, C).  Steps past N are the
    identity element."""
    d, C = lgssm.dim, Y.shape[1]
    dtype, dev = lgssm.A.dtype, lgssm.A.device
    ident = _elem_identity(1, d, C, dtype, dev)
    elems = tuple(
        _pad_block(e, B, T, i[0]) for e, i in zip(_filter_elements(lgssm, Y), ident)
    )
    totals = _elem_identity(B, d, C, dtype, dev)
    for t in range(T):
        totals = _combine_fast(totals, tuple(e[t] for e in elems))
    return totals


def block_inits(totals, init=None):
    """Phase 2: exclusive prefix over the block totals -> the filtered
    (m0 (B, d, C), P0 (B, d, d)) entering each block.  Block 0 starts from
    the identity element (m0 = 0, P0 = 0): the prior enters through step 0's
    A_0 = 0, Q_0 = Pinf.

    ``init`` = (m (d, C), P (d, d)), the filtered state of the step before
    the series (the segment carry of ``ssm/segmented.py``), enters as the
    element (0, m, P, 0, 0) in front of every block's prefix, block 0's
    too: the whole series then conditions on it."""
    B, d, C = totals[1].shape
    scanned = _scan(_combine_fast, totals)
    first = _elem_identity(1, d, C, totals[1].dtype, totals[1].device)
    prefix = tuple(torch.cat([i, s[:-1]]) for i, s in zip(first, scanned))
    if init is not None:
        m_c, P_c = (torch.as_tensor(x, dtype=totals[1].dtype, device=totals[1].device)
                    for x in init)
        zeros = torch.zeros_like(prefix[0])
        carry = (zeros, m_c.reshape(1, d, C).expand(B, d, C), P_c.reshape(1, d, d).expand(B, d, d),
                 torch.zeros_like(prefix[3]), zeros)
        prefix = _combine_fast(carry, prefix)  # the carry is earlier than every block
    return prefix[1], prefix[2]


def replay_blocks(lgssm: LGSSM, Y, m0, P0, B, T):
    """Phase 3: replay each block from its filtered init with the plain
    Kalman recursion (Joseph form).  Returns (m, P, mp, Pp, S, v) blocked as
    (T, B, ...) and the (T, B) mask of real steps; padded steps leave the
    state unchanged."""
    n, d = lgssm.num_steps, lgssm.dim
    dtype, dev = lgssm.A.dtype, lgssm.A.device
    H = lgssm.H.to(dtype)
    A_b = _pad_block(lgssm.A, B, T, 0.0)
    Q_b = _pad_block(lgssm.Q, B, T, 0.0)
    R_b = _pad_block(lgssm.R.expand(n), B, T, 1.0)
    Y_b = _pad_block(Y.to(dtype), B, T, 0.0)
    live = _pad_block(torch.ones(n, dtype=torch.bool, device=dev), B, T, False)
    I = torch.eye(d, dtype=dtype, device=dev)
    m_c, P_c = m0, P0
    C = Y.shape[1]
    outs = dict(
        m=Y.new_empty((T, B, d, C)), P=Y.new_empty((T, B, d, d)),
        mp=Y.new_empty((T, B, d, C)), Pp=Y.new_empty((T, B, d, d)),
        S=Y.new_empty((T, B)), v=Y.new_empty((T, B, C)),
    )
    for t in range(T):
        A_t, R_t = A_b[t], R_b[t]
        mp = A_t @ m_c
        Pp = A_t @ P_c @ A_t.transpose(-1, -2) + Q_b[t]
        S = torch.einsum("i,bij,j->b", H, Pp, H) + R_t
        v = Y_b[t] - torch.einsum("i,bic->bc", H, mp)
        K = torch.einsum("bij,j->bi", Pp, H) / S[:, None]
        m_new = mp + K[:, :, None] * v[:, None, :]
        ImKH = I - K[:, :, None] * H[None, None, :]
        P_new = ImKH @ Pp @ ImKH.transpose(-1, -2) + R_t[:, None, None] * (
            K[:, :, None] * K[:, None, :]
        )  # Joseph form
        for name, val in zip(("m", "P", "mp", "Pp", "S", "v"), (m_new, P_new, mp, Pp, S, v)):
            outs[name][t] = val
        mk = live[t][:, None, None]
        m_c = torch.where(mk, m_new, m_c)
        P_c = torch.where(mk, P_new, P_c)
    return outs, live


def blocked_filter(lgssm: LGSSM, y, num_blocks=None, init=None) -> FilterResult:
    """Forward filter with batched observation columns: ``FilterResult``
    parity with ``kalman_filter`` at ceil(N / B) sequential depth.

    ``init``: the filtered (m (d, C), P (d, d)) of the step before the
    series (a segment carry, ``block_inits``); the LGSSM's step 0 is then a
    real transition from it.  None: the prior, through A_0 = 0, Q_0 = Pinf."""
    Y, _ = _ensure_batch(y)
    n = lgssm.num_steps
    B = num_blocks_for(n, num_blocks)
    T = -(-n // B)
    m0, P0 = block_inits(block_totals(lgssm, Y, B, T), init)
    outs, _ = replay_blocks(lgssm, Y, m0, P0, B, T)
    o = {k: _unblock(v, n) for k, v in outs.items()}
    ll = -0.5 * (_LOG_2PI + torch.log(o["S"])[:, None] + o["v"] ** 2 / o["S"][:, None]).sum(0)
    return FilterResult(m=o["m"], P=o["P"], mp=o["mp"], Pp=o["Pp"], S=o["S"], v=o["v"], ll=ll)


def blocked_logpdf(lgssm: LGSSM, y, num_blocks=None):
    """log N(y | 0, Sigma) per column through the blocked filter."""
    res = blocked_filter(lgssm, y, num_blocks)
    return res.ll[0] if y.ndim == 1 else res.ll


def blocked_decorrelate(lgssm: LGSSM, y, num_blocks=None):
    """Whitening pass (ll, alpha = v / sqrt(S)) through the blocked filter;
    batched columns share one pass."""
    res = blocked_filter(lgssm, y, num_blocks)
    alpha = res.v / torch.sqrt(res.S)[:, None]
    if y.ndim == 1:
        return res.ll[0], alpha[:, 0]
    return res.ll, alpha


def _smooth_identity(B, d, C, dtype, device):
    eye = torch.eye(d, dtype=dtype, device=device).expand(B, d, d)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return (eye, zeros(B, d, C), zeros(B, d, d))


def with_terminal(later, terminal):
    """The suffix elements ``later`` (E (B, d, d), g (B, d, C), L (B, d, d))
    followed by the terminal element (0, g_t, L_t) after the last step,
    ``terminal`` = (g_t (d, C), L_t (d, d)): the recursions then continue
    into a later segment whose scanned state at its first step is
    (g_t, L_t).  None leaves ``later`` as it is."""
    if terminal is None:
        return later
    E, g, L = later
    g_t, L_t = (torch.as_tensor(x, dtype=E.dtype, device=E.device) for x in terminal)
    last = (torch.zeros_like(E), g_t.reshape((1,) + g.shape[1:]).expand(g.shape),
            L_t.reshape((1,) + L.shape[1:]).expand(L.shape))
    return _combine_smooth(last, later)  # later o terminal


def blocked_suffix_scan(E, g, L, num_blocks=None, terminal=None):
    """Inclusive suffix combine out_k = elem_k o elem_{k+1} o ... o elem_{n-1}
    of smoothing-algebra elements, blocked: within-block reverse reduction
    (ceil(N / B) sequential depth), reverse exclusive prefix over block
    totals, then one elementwise combine.  E (n, d, d), g (n, d, C),
    L (n, d, d).  ``terminal``: an optional (g_t (d, C), L_t (d, d))
    after the last step (``with_terminal``), the segment carry of
    ``ssm/segmented.py``."""
    n, d, C = E.shape[0], E.shape[-1], g.shape[-1]
    dtype, dev = E.dtype, E.device
    B = num_blocks_for(n, num_blocks)
    T = -(-n // B)

    ident = _smooth_identity(1, d, C, dtype, dev)
    elems = tuple(_pad_block(e, B, T, i[0]) for e, i in zip((E, g, L), ident))

    suffix = tuple(x.new_empty((T,) + x.shape[1:]) for x in elems)
    carry = _smooth_identity(B, d, C, dtype, dev)
    for t in range(T - 1, -1, -1):
        carry = _combine_smooth(carry, tuple(e[t] for e in elems))
        for s, c in zip(suffix, carry):
            s[t] = c

    scanned = _scan(_combine_smooth, carry, reverse=True)
    later = with_terminal(tuple(torch.cat([s[1:], i]) for s, i in zip(scanned, ident)), terminal)
    out = _combine_smooth(later, suffix)  # later (B, ...) broadcasts over T
    return tuple(_unblock(x, n) for x in out)


def blocked_smooth(
    lgssm: LGSSM, y, filter_result: FilterResult = None, num_blocks=None, boundary=None
) -> SmoothResult:
    """RTS smoother as a blocked reverse scan: ``SmoothResult`` parity with
    ``rts_smooth``.  The smoothed moments are the combined suffix elements,
    so no replay pass is needed.

    ``boundary``: (A1, mp1, Pp1, ms1, Ps1), the transition, predicted and
    smoothed moments of the step after the series (a later segment's first
    step, ``ssm/segmented.py``): the backward recursion then continues
    into that segment."""
    Y, single = _ensure_batch(y)
    res = filter_result if filter_result is not None else blocked_filter(lgssm, Y, num_blocks)
    next_step, terminal = (None, None) if boundary is None else (boundary[:3], boundary[3:])
    _, ms, Ps = blocked_suffix_scan(*_smoother_elements(lgssm, res, next_step),
                                    num_blocks=num_blocks, terminal=terminal)
    H = lgssm.H.to(lgssm.A.dtype)
    f_mean = torch.einsum("d,ndb->nb", H, ms)
    f_var = torch.einsum("d,nde,e->n", H, Ps, H)
    if single:
        f_mean = f_mean[:, 0]
    return SmoothResult(mean=f_mean, var=torch.clamp(f_var, min=0.0), ll=res.ll, ms=ms, Ps=Ps)


# ---------------------------------------------------------------------------
# Posterior draws by forward filtering, backward sampling (FFBS)
#
# The backward-sampling conditionals are the smoothing elements: with
# E_k = P_k A_{k+1}^T Pp_{k+1}^-1,
#     x_k | x_{k+1} ~ N(m_k + E_k (x_{k+1} - mp_{k+1}), L_k),
#     L_k = P_k - E_k Pp_{k+1} E_k^T,
# i.e. the smoothing elements (E, g, L) (last element (0, m_N, P_N)).
# With every step's noise drawn up front (eta_k = chol(L_k) xi_k) a joint
# draw is the affine suffix x_k = (g_k + eta_k) + E_k x_{k+1}: one blocked
# reverse scan instead of the O(N)-depth ``ssm/kalman.py::posterior_sample``.
#
# Precision is decided in one place, ``ffbs_elements``: every route of
# ``blocked_posterior_sample`` (the kernels, the sum-kernel route, the
# tensor code with or without ``filter_result``) forms (E, g, L) and the
# noise chol(L) xi there, in float64, from the filter's moments.
# ---------------------------------------------------------------------------


def _cholesky_small(P):
    """Lower Cholesky factors of a batch of small (..., d, d) matrices,
    elementwise: NaN or inf where a matrix is not positive definite, as the
    JAX package's factorization returns."""
    d = P.shape[-1]
    L = [[torch.zeros_like(P[..., 0, 0])] * d for _ in range(d)]
    for j in range(d):
        s = P[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, d):
            t = P[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t / L[j][j]
    return torch.stack([torch.stack(row, -1) for row in L], -2)


def _chol_floor(P):
    """Batched small-dim Cholesky robust to degenerate FFBS conditionals.

    L_k = P_k - E_k Pp_{k+1} E_k^T cancels to about machine epsilon at
    near-deterministic transitions (tiny time gaps); in float32 the
    residual can be indefinite far above any fixed jitter (the JAX package
    measured NaN draws at N = 20k with gaps of 1e-3 lengthscales).  Two
    guards: a jitter relative to each step's trace, and any step whose
    factor still comes out non-finite falls back to the square root of the
    diagonal -- at such steps the conditional noise is O(eps), so dropping
    its correlation is harmless."""
    d = P.shape[-1]
    eps, rel = (1e-12, 1e-10) if P.dtype == torch.float64 else (1e-8, 1e-5)
    eye = torch.eye(d, dtype=P.dtype, device=P.device)
    tr = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1) / d
    jit = eps + rel * torch.clamp(tr, min=0.0)
    L = _cholesky_small(P + jit[..., None, None] * eye)
    diag = torch.sqrt(torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=0.0) + eps)
    bad = ~torch.isfinite(L).all(-1).all(-1)
    return torch.where(bad[..., None, None], torch.diag_embed(diag), L)


def _combine_affine(later, earlier):
    """(earlier o later) of the affine part only: x_k = g_k + E_k x_later."""
    E_l, g_l = later
    E_e, g_e = earlier
    return E_e @ E_l, E_e @ g_l + g_e


def _affine_identity(B, d, C, dtype, device):
    eye = torch.eye(d, dtype=dtype, device=device).expand(B, d, d)
    return eye, torch.zeros((B, d, C), dtype=dtype, device=device)


def blocked_affine_suffix_scan(E, g, num_blocks=None, terminal=None):
    """``blocked_suffix_scan`` restricted to its affine half (E, g): the
    FFBS recursion x_k = g_k + E_k x_{k+1} needs no congruence L.
    E (n, d, d), g (n, d, C); ``terminal`` an optional (d, C) state after
    the last step (E_t = 0).  Returns the composed (E (n, d, d), x (n, d, C))."""
    n, d, C = E.shape[0], E.shape[-1], g.shape[-1]
    dtype, dev = E.dtype, E.device
    B = num_blocks_for(n, num_blocks)
    T = -(-n // B)
    ident = _affine_identity(1, d, C, dtype, dev)
    elems = tuple(_pad_block(e, B, T, i[0]) for e, i in zip((E, g), ident))

    suffix = tuple(x.new_empty((T,) + x.shape[1:]) for x in elems)
    carry = _affine_identity(B, d, C, dtype, dev)
    for t in range(T - 1, -1, -1):
        carry = _combine_affine(carry, tuple(e[t] for e in elems))
        for s, c in zip(suffix, carry):
            s[t] = c

    scanned = _scan(_combine_affine, carry, reverse=True)
    later = tuple(torch.cat([s[1:], i]) for s, i in zip(scanned, ident))
    if terminal is not None:
        x_t = torch.as_tensor(terminal, dtype=dtype, device=dev).reshape(1, d, C)
        later = _combine_affine((torch.zeros_like(later[0]), x_t.expand(B, d, C)), later)
    out = _combine_affine(later, suffix)  # later (B, ...) broadcasts over T
    return tuple(_unblock(x, n) for x in out)


def smoothing_elements(lgssm: LGSSM, m, P, dtype=torch.float32, next_step=None):
    """The smoothing elements, in ``dtype``, from the filtered moments
    m (N, d), P (N, d, d):

        E_k = P_k A_{k+1}^T Pp_{k+1}^-1,  g_k = m_k - E_k mp_{k+1},
        L_k = P_k - E_k Pp_{k+1} E_k^T,

    with the predicted moments formed again from (A, Q).  At the last step
    A_{k+1} = 0 and Pp_{k+1} = I stand in for the missing next step, which
    gives the terminal element (0, m_N, P_N); ``next_step`` = (A1 (d, d),
    mp1 (d,), Pp1 (d, d)), the step after the series (a later segment's
    first step), makes the last element a regular one toward it.  Returns
    E (N, d, d), g (N, d), L (N, d, d)."""
    A, Q, m, P = (x.to(dtype) for x in (lgssm.A, lgssm.Q, m, P))
    d = A.shape[-1]
    A1 = A.new_zeros((d, d)) if next_step is None else next_step[0].to(dtype)
    A_next = torch.cat([A[1:], A1[None]])
    Q_next = torch.cat([Q[1:], torch.eye(d, dtype=dtype, device=A.device)[None]])
    mp_next = (A_next @ m[:, :, None])[:, :, 0]
    Pp_next = A_next @ P @ A_next.transpose(-1, -2) + Q_next
    if next_step is not None:
        mp_next = torch.cat([mp_next[:-1], next_step[1].to(dtype).reshape(1, d)])
        Pp_next = torch.cat([Pp_next[:-1], next_step[2].to(dtype)[None]])
    E = P @ A_next.transpose(-1, -2) @ _inv_small(Pp_next)
    g = m - (E @ mp_next[:, :, None])[:, :, 0]
    L = P - E @ Pp_next @ E.transpose(-1, -2)
    return E, g, L


def ffbs_elements(lgssm: LGSSM, m, P, xi, dtype, next_step=None):
    """The inputs (E, g_s, L) of FFBS's sampling scan, in ``dtype``, from the
    filtered moments m (N, d), P (N, d, d) and standard normals xi
    (N, d, S): the smoothing elements (``next_step`` as there) and
    g_s = g + chol(L) xi (``_chol_floor``), formed in float64 and then cast.

    At small time gaps L_k = P_k - E_k Pp_{k+1} E_k^T is many orders of
    magnitude below P_k (1e-11 of it at gaps of 1e-3 lengthscales for
    Matern-5/2), so in float32 the difference is rounding, and its floored
    square root injects noise far above the true one: on the CPU the draws
    of a 2e4-step series came out with 2.4 times the smoothed variance.  In
    float64 it holds to about 1e-5 of L_k; a float32 scan then carries a
    noise well above its own rounding.  The JAX package forms them in the
    working precision."""
    f64 = torch.float64
    E, g, L = smoothing_elements(lgssm, m, P, f64, next_step)
    g_s = g[:, :, None] + _chol_floor(L) @ xi.to(device=E.device, dtype=f64)
    return tuple(x.to(dtype).contiguous() for x in (E, g_s, L))


def ffbs_draw(E, g, L, xi, num_blocks=None, x_term=None):
    """Joint posterior draws of the state from given FFBS elements:
    E (n, d, d), g (n, d, 1), L (n, d, d), xi (n, d, S) standard normals,
    x_term an optional (d, S) draw of the step after the series.  Returns
    x (n, d, S).  The elements are used in their own precision, as in the
    JAX package; ``blocked_posterior_sample`` forms them in float64
    (``ffbs_elements``) instead, since in float32 L is rounding at small
    time gaps."""
    g_s = g + _chol_floor(L) @ xi
    _, x = blocked_affine_suffix_scan(E, g_s, num_blocks, terminal=x_term)
    return x


def sample_from_moments(lgssm: LGSSM, m, P, xi, num_blocks=None, next_step=None, x_term=None):
    """Joint draws of the state x (N, d, S) from the filtered moments
    m (N, d), P (N, d, d) and standard normals xi (N, d, S):
    ``ffbs_elements`` cast to the LGSSM's dtype, then the tensor-code affine
    suffix scan.  ``next_step`` (as in ``smoothing_elements``) and
    ``x_term``, the (d, S) draw of the step after the series, carry a later
    segment's first step (``ssm/segmented.py``)."""
    E, g_s, _ = ffbs_elements(lgssm, m, P, xi, lgssm.A.dtype, next_step)
    return blocked_affine_suffix_scan(E, g_s, num_blocks, terminal=x_term)[1]


def blocked_posterior_sample(
    generator: torch.Generator,
    lgssm: LGSSM,
    y,
    num_samples: int = 1,
    num_blocks=None,
    filter_result: FilterResult = None,
    xi=None,
):
    """Joint posterior draws of f = H x given one observation column (the
    reference's ``posterior_rand``): (num_samples, N).

    ``filter_result``: a ``blocked_filter`` result, to stage the forward
    and the sampling pass apart.  ``xi``: (N, d, num_samples) standard
    normals that replace the draw from ``generator`` (the deterministic
    hook that holds the engines to each other).

    A float32 LGSSM with no ``filter_result`` goes to
    ``ops/smoother.py::pallas_posterior_sample`` (for an SDE the scan
    kernels take: K1/K2 forward, K4a/K4b backward, their plain versions on
    CPU tensors); everything else runs the tensor-code blocked filter and
    affine suffix scan here.  Every route forms its elements and noise with
    ``ffbs_elements``, in float64."""
    Y, _ = _ensure_batch(y)
    if Y.shape[1] != 1:
        raise ValueError("blocked_posterior_sample expects one observation column")
    n, d = lgssm.num_steps, lgssm.dim
    dtype, dev = lgssm.A.dtype, lgssm.A.device
    if filter_result is None and dtype == torch.float32:
        from gpar_at_scale_torch.ops.smoother import pallas_posterior_sample

        return pallas_posterior_sample(generator, lgssm, Y[:, 0], num_samples, xi=xi)
    res = filter_result if filter_result is not None else blocked_filter(lgssm, Y, num_blocks)
    if xi is None:
        xi = torch.randn((n, d, num_samples), generator=generator, dtype=dtype,
                         device=generator.device)
    xi = torch.as_tensor(xi).to(device=dev, dtype=dtype)
    x = sample_from_moments(lgssm, res.m[:, :, 0], res.P, xi, num_blocks)
    return torch.einsum("d,nds->sn", lgssm.H.to(dtype), x)
