"""Blocked-scan Kalman whitening on the card: kernels K1 and K2.

Counterpart of ``gpar_at_scale_tpu/ops/pallas_kalman.py::pallas_decorrelate``.
The series is split into ``nb`` contiguous time blocks of T steps and
whitened in three phases:

  phase 1 (K1, ``csrc/kalman_scan.cu::phase1_kernel``) -- reduce each
          block to its Sarkka & Garcia-Fernandez filtering element (A, b,
          C, eta, J): the kernel runs the filter through the block
          conditioned on the state entering it, which is the fold of the
          block's one-step elements without the combine's inverses;
  phase 2 (tensor code) -- exclusive associative prefix over the block
          elements, which gives every block its filtered init (m0, P0);
          the filtered state before the series (a segment carry,
          ``ssm/segmented.py``) joins here, in front of every block;
  phase 3 (K2, ``csrc/kalman_scan.cu::phase3_kernel``) -- replay each block
          from (m0, P0) with the plain Kalman recursion (Joseph form) and
          emit alpha = v / sqrt(S), log S, K, m, P per step and ll,
          sum log S per block.

The block count is chosen for the card, not the TPU's 1024 vector lanes:
``ssm.blocked.NUM_BLOCKS`` = 16384 blocks (T = 62 steps each at N = 1e6)
keeps every SM busy in K1/K2, while phase 2 stays 14 doubling levels of one
batched combine.

The kernels unroll d <= 3 and hard-code the emission row H = e1 (a single
Matern block).  ``decorrelate_blocked`` sends every other SDE (sum kernels)
to the associative-scan filter (``ssm/pkalman.py::parallel_filter``) with
the same contract, as the JAX package does; the choice is made from the
SDE's shape alone (``pallas_supported``), before anything is launched.

``phase1`` and ``phase3`` are the kernels' wrappers.  Beside them sit their
plain PyTorch versions (``phase1_plain``, ``phase3_plain``): phases 1 and 3
of ``ssm/blocked.py``'s filter, vectorised over blocks, used for tensors on
the CPU and as the kernels' check on the card.  The kernels stop each block
at step N; the plain versions pad the series and leave the running element
and state unchanged on padded steps, which is the same result.
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ops.build import CudaKernel, aligned16, ptr, require_f32
from gpar_at_scale_torch.ssm import blocked
from gpar_at_scale_torch.ssm.blocked import _unblock, block_totals, num_blocks_for, replay_blocks
from gpar_at_scale_torch.ssm.markov import LGSSM
from gpar_at_scale_torch.utils.observability import host_sync

_LOG_2PI = 1.8378770664093453

K1 = CudaKernel(
    "K1 kalman_phase1", "kalman_scan", "kalman_phase1",
    "gpar_at_scale_tpu/ops/pallas_kalman.py:154",
)
K2 = CudaKernel(
    "K2 kalman_phase3", "kalman_scan", "kalman_phase3",
    "gpar_at_scale_tpu/ops/pallas_kalman.py:236",
)


def _e1(d, like):
    H = torch.zeros(d, dtype=like.dtype, device=like.device)
    H[0] = 1.0
    host_sync()  # a host scalar written into a device tensor: a blocking copy
    return H


def pallas_supported(lgssm: LGSSM) -> bool:
    """True when the scan kernels can take this SSM: state dim <= 3 and
    emission row H = e1 (one Matern block).  Takes ``lgssm.e1`` where its
    constructor recorded it (``ssm.markov.lgssm_of`` does), else reads H
    back to the host."""
    if lgssm.dim > 3:
        return False
    if lgssm.e1 is not None:
        return lgssm.e1
    h = lgssm.H.detach().cpu()
    return bool(h[0] == 1.0 and torch.all(h[1:] == 0.0))


# ---------------------------------------------------------------------------
# Plain versions: the phases of ssm/blocked.py's filter for one column
# ---------------------------------------------------------------------------


def phase1_plain(A, Q, R, y, nb, T):
    """K1's plain version: per-block element reduction -> (A, b, C, eta, J)
    with shapes (nb, d, d), (nb, d), (nb, d, d), (nb, d), (nb, d, d)."""
    lg = LGSSM(A=A, Q=Q, H=_e1(A.shape[-1], A), R=R)
    eA, eb, eC, eeta, eJ = block_totals(lg, y[:, None], nb, T)
    return eA, eb[:, :, 0], eC, eeta[:, :, 0], eJ


def phase3_plain(A, Q, R, y, m0, P0, nb, T):
    """K2's plain version: per-block replay from (m0, P0).  Returns alpha,
    log S (n,), K, m (n, d), P (n, d, d), ll and sum log S per block (nb,)."""
    n = A.shape[0]
    lg = LGSSM(A=A, Q=Q, H=_e1(A.shape[-1], A), R=R)
    o, live = replay_blocks(lg, y[:, None], m0[:, :, None], P0, nb, T)
    S, v = o["S"], o["v"][..., 0]
    logS = torch.log(S)
    alpha = v / torch.sqrt(S)
    ll = torch.where(live, -0.5 * (_LOG_2PI + logS + alpha * alpha), 0.0).sum(0)
    ls = torch.where(live, logS, 0.0).sum(0)
    K = o["Pp"][..., :, 0] / S[..., None]
    return (
        _unblock(alpha, n), _unblock(logS, n), _unblock(K, n),
        _unblock(o["m"][..., 0], n), _unblock(o["P"], n), ll, ls,
    )


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _check_series(name, A, Q, R, y, nb, T):
    require_f32(name, A, Q, R, y)
    n, d = A.shape[0], A.shape[-1]
    if not 1 <= d <= 3 or A.shape != (n, d, d) or Q.shape != (n, d, d):
        raise ValueError(
            f"{name}: A, Q must be (n, d, d) with d <= 3, got {tuple(A.shape)}, {tuple(Q.shape)}"
        )
    if R.shape != (n,) or y.shape != (n,):
        raise ValueError(f"{name}: R, y must be ({n},), got {tuple(R.shape)}, {tuple(y.shape)}")
    if nb < 1 or T < 1 or nb * T < n:
        raise ValueError(f"{name}: {nb} blocks of {T} steps do not tile {n} steps")
    return n, d


def phase1(A, Q, R, y, nb: int, T: int):
    """K1: per-block element reduction, (A, b, C, eta, J) of shapes
    (nb, d, d), (nb, d), (nb, d, d), (nb, d), (nb, d, d).  Block b folds
    steps [b*T, min((b+1)*T, n)).  Launches on CUDA tensors, runs the plain
    version on CPU tensors."""
    n, d = _check_series("phase1", A, Q, R, y, nb, T)
    if not A.is_cuda:
        return phase1_plain(A, Q, R, y, nb, T)
    A, Q, R, y = (aligned16(x) for x in (A, Q, R, y))
    eA, eC, eJ = (torch.empty((nb, d, d), dtype=A.dtype, device=A.device) for _ in range(3))
    eb, eeta = (torch.empty((nb, d), dtype=A.dtype, device=A.device) for _ in range(2))
    K1(d, ptr(A), ptr(Q), ptr(R), ptr(y), n, T, nb,
       ptr(eA), ptr(eb), ptr(eC), ptr(eeta), ptr(eJ))
    return eA, eb, eC, eeta, eJ


def phase3(A, Q, R, y, m0, P0, nb: int, T: int, want_gains=True, want_moments=True):
    """K2: per-block replay from the filtered inits (m0 (nb, d), P0 (nb, d, d)).
    Returns alpha, log S (n,), K (n, d) or None, m (n, d) and P (n, d, d) or
    None, and ll, sum log S per block (nb,).  Launches on CUDA tensors, runs
    the plain version on CPU tensors."""
    n, d = _check_series("phase3", A, Q, R, y, nb, T)
    require_f32("phase3", A, m0, P0)
    if m0.shape != (nb, d) or P0.shape != (nb, d, d):
        raise ValueError(f"phase3: m0, P0 must be ({nb}, {d}), ({nb}, {d}, {d})")
    if not A.is_cuda:
        alpha, logs, K, m, P, ll, ls = phase3_plain(A, Q, R, y, m0, P0, nb, T)
        return (alpha, logs, K if want_gains else None) + (
            (m, P) if want_moments else (None, None)) + (ll, ls)
    A, Q, R, y = (aligned16(x) for x in (A, Q, R, y))
    new = lambda *s: torch.empty(s, dtype=A.dtype, device=A.device)  # noqa: E731
    alpha, logs = new(n), new(n)
    K = new(n, d) if want_gains else None
    m, P = (new(n, d), new(n, d, d)) if want_moments else (None, None)
    ll, ls = new(nb), new(nb)
    K2(d, ptr(A), ptr(Q), ptr(R), ptr(y), n, T, nb, ptr(m0), ptr(P0),
       ptr(alpha), ptr(logs), ptr(K), ptr(m), ptr(P), ptr(ll), ptr(ls))
    return alpha, logs, K, m, P, ll, ls


# ---------------------------------------------------------------------------
# Phase 2 and the wrapper
# ---------------------------------------------------------------------------


def block_inits(eA, eb, eC, eeta, eJ, init=None):
    """Phase 2: the filtered (m0 (nb, d), P0 (nb, d, d)) entering each block,
    from the block elements (``ssm.blocked.block_inits``); ``init`` =
    (m (d,), P (d, d)), the filtered state before the series, joins every
    block's prefix in front (a segment carry)."""
    if init is not None:
        init = (torch.as_tensor(init[0]).reshape(-1, 1), init[1])
    m0, P0 = blocked.block_inits((eA, eb[:, :, None], eC, eeta[:, :, None], eJ), init)
    return m0[:, :, 0].contiguous(), P0.contiguous()


def _f32_inputs(lgssm: LGSSM, y):
    n = lgssm.num_steps
    f32 = torch.float32
    A = lgssm.A.to(f32).contiguous()
    Q = lgssm.Q.to(f32).contiguous()
    R = lgssm.R.to(f32).expand(n).contiguous()
    y = torch.as_tensor(y, device=A.device).to(f32).reshape(n).contiguous()
    require_f32("decorrelate_blocked", A, Q, R, y)
    return A, Q, R, y


def _as_f32(lgssm: LGSSM) -> LGSSM:
    f32 = torch.float32
    return LGSSM(A=lgssm.A.to(f32), Q=lgssm.Q.to(f32), H=lgssm.H.to(f32), R=lgssm.R.to(f32))


def _decorrelate_fallback(lgssm: LGSSM, y, return_gains, return_moments, return_full):
    """``decorrelate_blocked``'s contract through the associative-scan
    filter, for the SDEs the kernels cannot take (the JAX package's
    ``_decorrelate_fallback``)."""
    from gpar_at_scale_torch.ssm.pkalman import parallel_filter

    lg = _as_f32(lgssm)
    y = torch.as_tensor(y, device=lg.A.device).to(torch.float32).reshape(lg.num_steps)
    res = parallel_filter(lg, y)
    S = res.S
    out = (res.ll[0], res.v[:, 0] / torch.sqrt(S), torch.log(S).sum())
    if return_gains or return_full:
        out += (S, (res.Pp @ lg.H) / S[:, None])
    if return_moments or return_full:
        out += (res.m[:, :, 0], res.P)
    return out


def decorrelate_blocked(
    lgssm: LGSSM,
    y,
    num_blocks=None,
    return_gains: bool = False,
    return_moments: bool = False,
    return_full: bool = False,
    init=None,
):
    """Whitening pass of one observation column through K1 and K2.

    float32.  Returns (ll, alpha (N,), logdet); ``return_gains`` adds the
    innovation variances S (N,) and Kalman gains K (N, d), which the column
    whitening kernel consumes (``ops/whiten.py``); ``return_moments`` adds
    the filtered moments m (N, d), P (N, d, d); ``return_full`` returns
    (ll, alpha, logdet, S, K, m, P).  The scalars are summed per block in
    float32 and across blocks in float64.  ``init`` = (m (d,), P (d, d)):
    the filtered state of the step before the series (a segment carry of
    ``ssm/segmented.py``), which enters phase 2 in front of every block;
    the LGSSM's step 0 is then a real transition from it.

    Dispatch, by the SDE's shape alone: state dim <= 3 with H = e1 runs K1
    and K2 (tensors on the card launch them, tensors on the CPU take the
    plain versions); any other SDE runs the associative-scan filter in
    float32 (``_decorrelate_fallback``) and launches nothing."""
    if not pallas_supported(lgssm):
        if init is not None:
            raise ValueError("decorrelate_blocked: init= is for the kernels' SDEs "
                             "(ssm/segmented.py sends the others to the tensor code)")
        return _decorrelate_fallback(lgssm, y, return_gains, return_moments, return_full)
    A, Q, R, y = _f32_inputs(lgssm, y)
    n = A.shape[0]
    nb = num_blocks_for(n, num_blocks)
    T = -(-n // nb)
    want_gains = return_gains or return_full
    want_moments = return_moments or return_full
    m0, P0 = block_inits(*phase1(A, Q, R, y, nb, T), init=init)
    alpha, logs, K, m, P, ll_b, ls_b = phase3(
        A, Q, R, y, m0, P0, nb, T, want_gains, want_moments
    )
    ll = ll_b.double().sum().float()
    logdet = ls_b.double().sum().float()
    out = (ll, alpha, logdet)
    if want_gains:
        out += (torch.exp(logs), K)
    if want_moments:
        out += (m, P)
    return out
