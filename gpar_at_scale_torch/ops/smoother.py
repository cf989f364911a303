"""Blocked suffix scan on the card: kernels K4a and K4b, and the smoother,
with its elements over many columns on kernel K7.

Counterpart of ``gpar_at_scale_tpu/ops/pallas_smoother.py``.  The scan
takes per-step affine + congruence elements (E_k (d, d), g_k (d, C),
L_k (d, d)) and returns, for every step k,

    v_k = g_k + E_k v_{k+1},   M_k = L_k + E_k M_{k+1} E_k^T,   v_n = M_n = 0,

in the three phases of the JAX package's ``pallas_suffix_scan``:

  R1 (K4a, ``csrc/suffix_scan.cu::suffix_reduce_kernel``) -- each time
     block folds its elements, last step first, into one suffix element;
  R2 (tensor code) -- a reverse exclusive prefix over the block elements
     (``ssm.blocked._scan`` of ``_combine_smooth``), which gives every block
     the (g0, L0) of all later blocks; a terminal element after the last
     step (a later segment's carry, ``ssm/segmented.py``) joins here;
  R3 (K4b, ``csrc/suffix_scan.cu::suffix_replay_kernel``) -- each block
     replays its steps backwards from (g0, L0) and writes (v, M) at every
     step.

The column axis C is the JAX package's ``ssm/blocked.py::
blocked_suffix_scan`` contract (its TPU kernel takes one column): E and L
are shared by the columns, g carries them.  It is the backward engine of
the RTS smoother (``pallas_smooth``, C = 1), of the disturbance-smoother
gradients (``ops/grad.py``: the adjoint r with C = 1 for one series, C =
M + 1 for the whitened Gram, and the shared information matrix N), and of
posterior draws by FFBS (``pallas_posterior_sample``: the S draws as the
columns, v the draw).

The block count is ``ssm.blocked.num_blocks_for(n)``, as for K1/K2: 16384
blocks of 62 steps at n = 1e6.  ``suffix_reduce`` and ``suffix_replay`` are
the kernels' wrappers; ``r1_plain`` and ``r3_plain`` their plain versions,
the same recursions as tensor code vectorised over blocks and columns, for
CPU tensors and as the kernels' check on the card.  The kernels stop each
block at step n; the plain versions pad with the identity element
(I, 0, 0), which leaves (v, M) unchanged -- the same result.

K7 (``csrc/smoothing.cu``, wrapper ``column_elements``, plain version
``column_elements_plain``) forms the scan's input for the RTS smoother of
many columns at once (``smooth_columns``): the shared E, L and every
column's g = m - E A' m in one pass, g over the filtered means in place.
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ops.build import CudaKernel, aligned16, ptr, require_f32
from gpar_at_scale_torch.ops.kalman import _as_f32, decorrelate_blocked, pallas_supported
from gpar_at_scale_torch.ssm.blocked import (
    _pad_block,
    _smooth_identity,
    _unblock,
    ffbs_elements,
    num_blocks_for,
    sample_from_moments,
    smoothing_elements,
    with_terminal,
)
from gpar_at_scale_torch.ssm.markov import LGSSM
from gpar_at_scale_torch.ssm.pkalman import _combine_smooth, _scan

K4A = CudaKernel(
    "K4a suffix_reduce", "suffix_scan", "suffix_reduce",
    "gpar_at_scale_tpu/ops/pallas_smoother.py:135",
)
K4B = CudaKernel(
    "K4b suffix_replay", "suffix_scan", "suffix_replay",
    "gpar_at_scale_tpu/ops/pallas_smoother.py:187",
)
K7 = CudaKernel(
    "K7 smoothing_elements", "smoothing", "smoothing_elements",
    "no pallas_call: gpar_at_scale_tpu/ssm/blocked.py's smoothing elements, fused by XLA",
)
# K7 holds a tile of at least 4 steps of m (d C floats each) in shared memory.
SMOOTHING_MAX_COLUMNS = 4096


# ---------------------------------------------------------------------------
# Plain versions: phases R1 and R3 as tensor code
# ---------------------------------------------------------------------------


def _blocked_elements(E, g, L, nb, T):
    """(E, g, L) padded with the identity element and blocked to (T, nb, ...)."""
    eye = torch.eye(E.shape[-1], dtype=E.dtype, device=E.device)
    return _pad_block(E, nb, T, eye), _pad_block(g, nb, T, 0.0), _pad_block(L, nb, T, 0.0)


def r1_plain(E, g, L, nb, T):
    """K4a's plain version: each block's suffix element (E (nb, d, d),
    g (nb, d, C), L (nb, d, d)), folded from the block's last step to its
    first."""
    Eb, gb, Lb = _blocked_elements(E, g, L, nb, T)
    carry = _smooth_identity(nb, E.shape[-1], g.shape[-1], E.dtype, E.device)
    for t in range(T - 1, -1, -1):
        carry = _combine_smooth(carry, (Eb[t], gb[t], Lb[t]))
    return carry


def r3_plain(E, g, L, g0, L0, nb, T):
    """K4b's plain version: each block replayed backwards from the suffix
    (g0 (nb, d, C), L0 (nb, d, d)) of the later blocks.  Returns v (n, d, C)
    and M (n, d, d)."""
    n = E.shape[0]
    Eb, gb, Lb = _blocked_elements(E, g, L, nb, T)
    v, M = g0, L0
    vs, Ms = g.new_empty((T,) + g0.shape), L.new_empty((T,) + L0.shape)
    for t in range(T - 1, -1, -1):
        v = gb[t] + Eb[t] @ v
        M = Lb[t] + Eb[t] @ M @ Eb[t].transpose(-1, -2)
        vs[t], Ms[t] = v, M
    return _unblock(vs, n), _unblock(Ms, n)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _check_elements(name, E, g, L, nb, T):
    require_f32(name, E, g, L)
    n, d = E.shape[0], E.shape[-1]
    if not 1 <= d <= 3 or E.shape != (n, d, d) or L.shape != (n, d, d):
        raise ValueError(
            f"{name}: E, L must be (n, d, d) with d <= 3, got {tuple(E.shape)}, {tuple(L.shape)}"
        )
    if g.ndim != 3 or g.shape[:2] != (n, d):
        raise ValueError(f"{name}: g must be ({n}, {d}, C), got {tuple(g.shape)}")
    if nb < 1 or T < 1 or nb * T < n:
        raise ValueError(f"{name}: {nb} blocks of {T} steps do not tile {n} steps")
    return n, d, g.shape[2]


def suffix_reduce(E, g, L, nb: int, T: int):
    """K4a: each block's suffix element (E (nb, d, d), g (nb, d, C),
    L (nb, d, d)); block b folds steps [b*T, min((b+1)*T, n)).  Launches on
    CUDA tensors, runs the plain version on CPU tensors."""
    n, d, C = _check_elements("suffix_reduce", E, g, L, nb, T)
    if not E.is_cuda:
        return r1_plain(E, g, L, nb, T)
    bE, bL = (torch.empty((nb, d, d), dtype=E.dtype, device=E.device) for _ in range(2))
    bg = torch.empty((nb, d, C), dtype=E.dtype, device=E.device)
    K4A(d, ptr(E), ptr(g), ptr(L), n, T, nb, C, ptr(bE), ptr(bg), ptr(bL))
    return bE, bg, bL


def suffix_replay(E, g, L, g0, L0, nb: int, T: int):
    """K4b: (v (n, d, C), M (n, d, d)) by replaying each block backwards from
    the suffix (g0 (nb, d, C), L0 (nb, d, d)) of the later blocks.  Launches
    on CUDA tensors, runs the plain version on CPU tensors."""
    n, d, C = _check_elements("suffix_replay", E, g, L, nb, T)
    require_f32("suffix_replay", E, g0, L0)
    if g0.shape != (nb, d, C) or L0.shape != (nb, d, d):
        raise ValueError(f"suffix_replay: g0, L0 must be ({nb}, {d}, {C}), ({nb}, {d}, {d})")
    if not E.is_cuda:
        return r3_plain(E, g, L, g0, L0, nb, T)
    E, g, L = (aligned16(x) for x in (E, g, L))
    v = torch.empty((n, d, C), dtype=E.dtype, device=E.device)
    M = torch.empty((n, d, d), dtype=E.dtype, device=E.device)
    K4B(d, ptr(E), ptr(g), ptr(L), n, T, nb, C, ptr(g0), ptr(L0), ptr(v), ptr(M))
    return v, M


def block_suffix_inits(bE, bg, bL, terminal=None):
    """Phase R2: the exclusive suffix (g0, L0) entering each block from the
    blocks after it; the last block starts from (0, 0), or from
    ``terminal`` = (g_t (d, C), L_t (d, d)), the element after the last step
    (a segment carry, ``ssm.blocked.with_terminal``)."""
    inc = _scan(_combine_smooth, (bE, bg, bL), reverse=True)
    ident = _smooth_identity(1, bE.shape[-1], bg.shape[-1], bE.dtype, bE.device)
    _, g0, L0 = with_terminal(tuple(torch.cat([x[1:], i]) for x, i in zip(inc, ident)), terminal)
    return g0.contiguous(), L0.contiguous()


def suffix_scan(E, g, L, terminal=None):
    """(v, M) of the suffix recursions v_k = g_k + E_k v_{k+1},
    M_k = L_k + E_k M_{k+1} E_k^T from v_n = M_n = 0, or from
    ``terminal`` = (v_n (d, C), M_n (d, d)), the state after the last step.

    float32, d <= 3.  E, L (n, d, d); g (n, d) or (n, d, C), and v comes
    back in g's shape; M is (n, d, d).  Tensors on the card launch K4a and
    K4b; tensors on the CPU take the plain versions."""
    single = g.ndim == 2
    if single:
        g = g[:, :, None]
    E, g, L = (x.contiguous() for x in (E, g, L))
    n = E.shape[0]
    nb = num_blocks_for(n)
    T = -(-n // nb)
    g0, L0 = block_suffix_inits(*suffix_reduce(E, g, L, nb, T), terminal)
    v, M = suffix_replay(E, g, L, g0, L0, nb, T)
    return (v[:, :, 0] if single else v), M


# ---------------------------------------------------------------------------
# The RTS smoother on the kernels
# ---------------------------------------------------------------------------


def smooth_moments(lgssm: LGSSM, m, P, boundary=None):
    """The smoothed state moments ms (N, d), Ps (N, d, d) and the smoother
    gains E (N, d, d) from the filtered moments m (N, d), P (N, d, d):
    float32 smoothing elements (``ssm.blocked.smoothing_elements``), then
    K4a/K4b.  ``boundary`` = (A1, mp1, Pp1, ms1, Ps1), the transition,
    predicted and smoothed moments of the step after the series (a later
    segment's first step), continues the recursion into it."""
    next_step, terminal = (None, None) if boundary is None else (boundary[:3], boundary[3:])
    E, g, L = smoothing_elements(lgssm, m, P, next_step=next_step)
    if terminal is not None:
        terminal = (terminal[0].reshape(-1, 1), terminal[1])
    ms, Ps = suffix_scan(E, g, L, terminal)
    return ms, Ps, E


def pallas_smooth(lgssm: LGSSM, y, return_state: bool = False, boundary=None):
    """Blocked-scan RTS smoother of one float32 series: (f_mean (N,),
    f_var (N,), ll); with ``return_state`` also the smoothed state moments
    ms (N, d), Ps (N, d, d) and the smoother gains E (N, d, d) (E[k] maps
    step k+1's smoothed moments back to step k).

    The forward filter with moments runs on K1/K2, the backward pass on
    K4a/K4b over the smoothing elements (``smooth_moments``); ``boundary``
    carries the step after the series (a later segment's first step).

    Dispatch, by the SDE's shape alone (``pallas_supported``): sum-kernel
    SDEs (state dim > 3 or H != e1) run the associative-scan smoother
    (``ssm/pkalman.py::parallel_smooth``) in float32 and launch nothing; as
    in the JAX package, their gains E come back as zeros.  They take no
    boundary (``ssm/segmented.py`` runs them on the tensor code)."""
    if not pallas_supported(lgssm):
        if boundary is not None:
            raise ValueError("pallas_smooth: segment carries are for the kernels' SDEs")
        from gpar_at_scale_torch.ssm.pkalman import parallel_smooth

        lg = _as_f32(lgssm)
        sm = parallel_smooth(lg, torch.as_tensor(y, device=lg.A.device).to(torch.float32))
        if not return_state:
            return sm.mean, sm.var, sm.ll[0]
        return sm.mean, sm.var, sm.ll[0], sm.ms[:, :, 0], sm.Ps, torch.zeros_like(sm.Ps)
    ll, _, _, m, P = decorrelate_blocked(lgssm, y, return_moments=True)
    ms, Ps, E = smooth_moments(lgssm, m, P, boundary)
    f_mean = ms[:, 0]
    f_var = torch.clamp(Ps[:, 0, 0], min=0.0)
    if not return_state:
        return f_mean, f_var, ll
    return f_mean, f_var, ll, ms, Ps, E


def column_elements_plain(lgssm: LGSSM, m, P):
    """K7's plain version: ``ssm.blocked.smoothing_elements``' E and L, and
    every column's g = m - E (A_{k+1} m), written over m."""
    E, _, L = smoothing_elements(lgssm, m[:, :, 0], P)
    A = lgssm.A.to(m.dtype)
    m -= E @ (torch.cat([A[1:], torch.zeros_like(A[:1])]) @ m)
    return E, L


def column_elements(lgssm: LGSSM, m, P):
    """K7: the RTS smoother's elements over the C columns of the filtered
    means m (n, d, C), from m and the filtered covariances P (n, d, d):
    E, L (n, d, d) as ``ssm.blocked.smoothing_elements`` forms them, and
    g = m - E A_{k+1} m written over m (A_{k+1} = 0 at the last step).
    float32, d <= 3, contiguous.  Launches on CUDA tensors, runs the plain
    version on CPU tensors."""
    A, Q = (x.to(torch.float32).contiguous() for x in (lgssm.A, lgssm.Q))
    require_f32("column_elements", A, Q, m, P)
    n, d = A.shape[0], A.shape[-1]
    if not 1 <= d <= 3 or Q.shape != (n, d, d) or P.shape != (n, d, d):
        raise ValueError(f"column_elements: A, Q, P must be (n, d, d) with d <= 3, got "
                         f"{tuple(A.shape)}, {tuple(Q.shape)}, {tuple(P.shape)}")
    C = m.shape[2] if m.ndim == 3 else 0
    if m.shape != (n, d, C) or not 1 <= C <= SMOOTHING_MAX_COLUMNS:
        raise ValueError(f"column_elements: m must be ({n}, {d}, C) with 1 <= C <= "
                         f"{SMOOTHING_MAX_COLUMNS}, got {tuple(m.shape)}")
    if not m.is_cuda:
        return column_elements_plain(lgssm, m, P)
    A, Q, P, g = (aligned16(x) for x in (A, Q, P, m))
    E, L = (torch.empty((n, d, d), dtype=torch.float32, device=m.device) for _ in range(2))
    K7(d, ptr(A), ptr(Q), ptr(P), ptr(g), n, C, ptr(E), ptr(L))
    if g is not m:
        m.copy_(g)
    return E, L


def smooth_columns(lgssm: LGSSM, cols):
    """The RTS smoother of the columns ``cols`` (N, C): (means (N, C),
    variances (N,)) of the first state component.

    float32 on the kernels: the y = 0 gain pass (K1/K2) and K3 with its
    filtered means, the smoothing elements (K7: E, L shared by the columns,
    g per column), one C-column suffix scan (K4a/K4b); one launch of each
    whatever N and C.  The caller should hold no other reference to
    ``cols``: it is dropped once K3 has read it.  Columns in another
    precision, or SDEs the kernels cannot take, run the tensor-code
    blocked smoother in their own precision (``ssm/blocked.py::
    blocked_smooth``), as ``gp/dtc.py::predict_scaled`` does above
    DENSE_N_MAX.

    Series laid end to end (``ssm/markov.py::lgssm_batch_of``) smooth as
    each alone: the filter restarts at each series' first step (A = 0,
    Q = Pinf) and the gain E into it is zero."""
    from gpar_at_scale_torch.ops.whiten import gain_rows, whiten_sweep
    from gpar_at_scale_torch.ssm.blocked import blocked_smooth

    if cols.dtype != torch.float32 or not pallas_supported(lgssm):
        sm = blocked_smooth(lgssm, cols)
        return sm.mean, sm.var
    A = lgssm.A.to(torch.float32).contiguous()
    n, d = A.shape[0], A.shape[-1]
    _, _, _, S, K, _, P = decorrelate_blocked(
        lgssm, cols.new_zeros(n), return_gains=True, return_moments=True)
    _, alpha, m = whiten_sweep(gain_rows(A, S, K), cols.contiguous(), d, want_means=True)
    del cols, alpha, S, K
    E, L = column_elements(lgssm, m, P)  # g over m
    del P
    ms, Ps = suffix_scan(E, m, L)
    return ms[:, 0, :], torch.clamp(Ps[:, 0, 0], min=0.0)


# ---------------------------------------------------------------------------
# Posterior draws (FFBS) on the kernels
# ---------------------------------------------------------------------------


def draw_states(lgssm: LGSSM, m, P, xi, next_step=None, x_term=None):
    """Joint draws of the state x (N, d, S) from the filtered moments
    m (N, d), P (N, d, d) and standard normals xi (N, d, S): the affine
    suffix x_k = g_s_k + E_k x_{k+1} over ``ssm.blocked.ffbs_elements``
    (float64, cast to float32) on K4a/K4b with C = S.  ``next_step``
    (A1, mp1, Pp1) and ``x_term`` (d, S), the step after the series and its
    draw, carry a later segment's first step."""
    E, g_s, L = ffbs_elements(lgssm, m, P, xi, torch.float32, next_step)
    terminal = None if x_term is None else (x_term, torch.zeros_like(L[0]))
    return suffix_scan(E, g_s, L, terminal)[0]


def pallas_posterior_sample(generator: torch.Generator, lgssm: LGSSM, y, num_samples: int = 1,
                            xi=None, next_step=None, x_term=None):
    """Joint posterior draws of f given one float32 series, (num_samples, N):
    the filter with moments on K1/K2, then the sampling pass on K4a/K4b
    (``draw_states``; the kernels also replay the congruence M, which the
    draws do not need: (N, d, d) more to write).  ``xi`` (N, d, num_samples)
    replaces the standard normals drawn from ``generator``; ``next_step``
    and ``x_term`` carry the step after the series (``draw_states``).

    Dispatch, by the SDE's shape alone (``pallas_supported``): sum-kernel
    SDEs take the associative-scan filter and the tensor-code affine scan
    (``ssm.blocked.sample_from_moments``), launch nothing and take no
    carries."""
    lg = _as_f32(lgssm)
    n, d = lg.num_steps, lg.dim
    dev = lg.A.device
    if xi is None:
        xi = torch.randn((n, d, num_samples), generator=generator, dtype=torch.float32,
                         device=generator.device)
    xi = torch.as_tensor(xi).to(device=dev, dtype=torch.float32)
    y = torch.as_tensor(y, device=dev).to(torch.float32)
    if not pallas_supported(lgssm):
        if next_step is not None or x_term is not None:
            raise ValueError("pallas_posterior_sample: segment carries are for the kernels' SDEs")
        from gpar_at_scale_torch.ssm.pkalman import parallel_filter

        res = parallel_filter(lg, y)
        return torch.einsum("d,nds->sn", lg.H, sample_from_moments(lg, res.m[:, :, 0], res.P, xi))
    _, _, _, m, P = decorrelate_blocked(lgssm, y, return_moments=True)
    return draw_states(lgssm, m, P, xi, next_step, x_term)[:, 0, :].T
