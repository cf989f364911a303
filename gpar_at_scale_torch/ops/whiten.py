"""Many-column Kalman whitening on the card: kernel K3, the DTC hot path.

Counterpart of ``gpar_at_scale_tpu/ops/pallas_whiten.py::
pallas_whiten_columns`` and of the forward half of
``gpar_at_scale_tpu/ops/pallas_grad.py::whiten_gram``.  The covariance and
gain recursion of the filter does not depend on the observations, so K1/K2
run it once with y = 0 (``ops/kalman.py``) and hand over one gain row per
step, ``[S, log S, mask, K (d), A[0, :] (d), M = (I - K H) A (d*d)]``.  K3
(``csrc/whiten.cu``) then runs only the affine mean recursion per column:

    v_k = y_k - A_k[0, :] . m_{k-1},   alpha_k = v_k / sqrt(S_k)
    m_k = M_k m_{k-1} + K_k y_k,       ll -= (log 2 pi + log S_k + alpha_k^2) / 2

The recursion is affine once the gains are fixed, so both K3 and its plain
version (``whiten_sweep_plain``) run it as a blocked affine scan over time:
compose each time block's maps, take an exclusive prefix over the block
maps, replay each block from the mean entering it.  ``whiten_sweep`` is K3's
wrapper; both take the blocking (nb blocks of T steps, ``num_blocks_for``
by default), so the kernel and its plain version can be held to each other
on the same blocking.  Asked for them (the training path), both also
return every column's filtered mean m_k (N, d, B), which the gradient of
``whiten_gram`` needs (``ops/grad.py``).

``whiten_columns`` is the one forward path (K1/K2 on y = 0, then K3).
``whiten_gram`` forms the Gram from it and is differentiable: when an
input requires grad it goes through ``ops.grad.WhitenGram``, whose backward
runs the suffix-scan kernels K4a/K4b.
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ops.build import CudaKernel, ptr, require_f32
from gpar_at_scale_torch.ops.kalman import _e1, decorrelate_blocked, pallas_supported
from gpar_at_scale_torch.ssm.blocked import _pad_block, _unblock, num_blocks_for
from gpar_at_scale_torch.ssm.markov import LGSSM
from gpar_at_scale_torch.ssm.pkalman import _scan

_LOG_2PI = 1.8378770664093453

K3 = CudaKernel(
    "K3 whiten_columns", "whiten", "whiten_columns",
    "gpar_at_scale_tpu/ops/pallas_whiten.py:39",
)


def gain_rows(A, S, K):
    """(N, 3 + 2d + d*d) gain rows [S, log S, mask, K, A[0, :], (I - K H) A]
    from the y = 0 filter pass, H = e1; mask is 1 on every real step."""
    n, d = K.shape
    M = A - K[:, :, None] * A[:, None, 0, :]
    ones = torch.ones((n, 1), dtype=A.dtype, device=A.device)
    return torch.cat(
        [S[:, None], torch.log(S)[:, None], ones, K, A[:, 0, :], M.reshape(n, d * d)], dim=1
    ).contiguous()


def _blocking(n, nb=None, T=None):
    """(nb, T): ``num_blocks_for(n)`` blocks of ceil(n / nb) steps unless
    given; nb T must cover n."""
    nb = num_blocks_for(n) if nb is None else int(nb)
    T = -(-n // nb) if T is None else int(T)
    if nb < 1 or T < 1 or nb * T < n:
        raise ValueError(f"whiten_sweep: {nb} blocks of {T} steps do not tile {n} steps")
    return nb, T


def whiten_sweep_plain(gains, Y, d, want_means=False, nb=None, T=None):
    """K3's plain version: (ll (B,), alpha (N, B)) by a blocked affine scan
    over nb blocks of T steps, and the filtered means m (N, d, B) if
    ``want_means``.

    Phase 1 composes each block's affine maps m -> M m + K y; an exclusive
    prefix over the block maps gives the mean entering every block; phase 3
    replays each block and emits alpha, the means and each block's ll,
    summed over blocks in float64."""
    n, B = Y.shape
    nb, T = _blocking(n, nb, T)
    pad_row = torch.zeros(gains.shape[1], dtype=gains.dtype, device=gains.device)
    pad_row[0] = 1.0  # padded rows: S = 1, mask = 0 (as the JAX wrapper pads)
    g = _pad_block(gains, nb, T, pad_row)  # (T, nb, G)
    Yb = _pad_block(Y, nb, T, 0.0)  # (T, nb, B)
    S, logS, mask = g[..., 0], g[..., 1], g[..., 2]
    K = g[..., 3 : 3 + d]
    A0 = g[..., 3 + d : 3 + 2 * d]
    M = g[..., 3 + 2 * d :].reshape(T, nb, d, d)
    live = mask > 0.5

    eye = torch.eye(d, dtype=Y.dtype, device=Y.device).expand(nb, d, d)
    Mt, ct = eye, Y.new_zeros((nb, d, B))
    for t in range(T):
        keep = live[t][:, None, None]
        Mt = torch.where(keep, M[t] @ Mt, Mt)
        ct = torch.where(keep, M[t] @ ct + K[t][:, :, None] * Yb[t][:, None, :], ct)

    def affine(earlier, later):
        return later[0] @ earlier[0], later[0] @ earlier[1] + later[1]

    _, c_in = _scan(affine, (Mt, ct))
    m = torch.cat([Y.new_zeros((1, d, B)), c_in[:-1]])  # mean entering each block

    alpha = Y.new_empty((T, nb, B))
    means = Y.new_empty((T, nb, d, B)) if want_means else None
    ll = Y.new_zeros((nb, B))
    for t in range(T):
        msk = mask[t][:, None]
        v = Yb[t] - (A0[t][:, None, :] @ m)[:, 0, :]
        a = v * torch.rsqrt(S[t])[:, None] * msk
        m_new = M[t] @ m + K[t][:, :, None] * Yb[t][:, None, :]
        m = torch.where(live[t][:, None, None], m_new, m)
        ll = ll - 0.5 * msk * (_LOG_2PI + logS[t][:, None] + a * a)
        alpha[t] = a
        if want_means:
            means[t] = m
    out = (ll.double().sum(0).to(Y.dtype), _unblock(alpha, n))
    return out + (_unblock(means, n),) if want_means else out


def whiten_sweep(gains, Y, d: int, want_means: bool = False, nb=None, T=None):
    """K3: (ll (B,), alpha (N, B)) of the columns of Y (N, B) given the gain
    rows (N, 3 + 2d + d*d), and the filtered means m (N, d, B) if
    ``want_means``, over nb time blocks of T steps (``num_blocks_for(N)``
    by default).  Launches on CUDA tensors (one call, four CUDA launches:
    ``csrc/whiten.cu``), runs the plain version on CPU tensors."""
    require_f32("whiten_sweep", gains, Y)
    n, B = Y.shape
    if not 1 <= d <= 3 or gains.shape != (n, 3 + 2 * d + d * d):
        raise ValueError(f"whiten_sweep: gains {tuple(gains.shape)} do not fit d={d}, N={n}")
    nb, T = _blocking(n, nb, T)
    if not Y.is_cuda:
        return whiten_sweep_plain(gains, Y, d, want_means, nb, T)
    new = lambda *s: torch.empty(s, dtype=Y.dtype, device=Y.device)  # noqa: E731
    alpha, ll = new(n, B), new(B)
    m = new(n, d, B) if want_means else None
    # ll partials (at most nb, B) in float64, block maps Mt (nb, d, d),
    # offsets and entering means (B, nb, d) each
    scratch = new(nb * (d * d + 2 * B * d + 2 * B))
    K3(d, ptr(gains), ptr(Y), n, B, nb, T, ptr(alpha), ptr(ll), ptr(m), ptr(scratch))
    return (ll, alpha, m) if want_means else (ll, alpha)


@torch.no_grad()
def whiten_columns(lgssm: LGSSM, Y, want_aux: bool = False):
    """Batched whitening of Y (N,) or (N, B) -> (ll (B,), alpha (N, B),
    logdet), and with ``want_aux`` a fourth entry aux = (e, S, K, m, P) --
    innovations (N, B), innovation variances (N,), gains (N, d), filtered
    means (N, d, B) and covariances (N, d, d) -- for the backward pass
    (``ssm.blocked_grad.whiten_bwd_elements``).

    float32, state dim <= 3, H = e1 (``pallas_supported``; any other SDE
    raises ``ValueError``: callers send it to the associative-scan engine,
    as ``gp/dtc.py::_whiten_all`` does), forward only (gradients go through
    ``whiten_gram``).  The gains come from K1/K2 run on y = 0; K3 then
    sweeps the B columns.  Tensors on the card launch the kernels; tensors
    on the CPU take the plain versions."""
    if not pallas_supported(lgssm):
        raise ValueError("whiten_columns takes state dim <= 3 with H = e1 (pallas_supported)")
    A = lgssm.A.to(torch.float32).contiguous()
    Y = torch.as_tensor(Y, device=A.device).to(torch.float32)
    if Y.ndim == 1:
        Y = Y[:, None]
    Y = Y.contiguous()
    n, d = A.shape[0], A.shape[-1]
    if Y.shape[0] != n:
        raise ValueError(f"whiten_columns: Y has {Y.shape[0]} rows for an {n}-step SSM")
    # the filtered moments of the y = 0 pass only for the backward: K2 then
    # writes P (and m, unused) beside alpha, log S and K
    gain_pass = decorrelate_blocked(
        lgssm, torch.zeros(n, dtype=torch.float32, device=A.device), return_gains=True,
        return_moments=want_aux,
    )
    logdet, S, K = gain_pass[2:5]
    out = whiten_sweep(gain_rows(A, S, K), Y, d, want_means=want_aux)
    if not want_aux:
        return out + (logdet,)
    ll, alpha, m = out
    return ll, alpha, logdet, (alpha * torch.sqrt(S)[:, None], S, K, m, gain_pass[6])


def gram_forward(A, Q, R, U, want_aux: bool = False):
    """(G, logdet, aux) of float32 (A, Q, R (N,), U (N, B)) through
    ``whiten_columns``: G = W^T W of the whitened columns and logdet in
    float64, aux as there if ``want_aux``, else None."""
    lg = LGSSM(A=A, Q=Q, H=_e1(A.shape[-1], A), R=R, e1=True)
    out = whiten_columns(lg, U, want_aux=want_aux)
    W = out[1].double()
    return W.T @ W, out[2].double(), out[3] if want_aux else None


def whiten_gram(lgssm: LGSSM, U):
    """(G, logdet) with G = U^T Sigma_y^-1 U, differentiable in the LGSSM's
    (A, Q, R) and in U.

    The whitened columns W come from the kernels in float32; G = W^T W is
    formed in float64.  At N = 1e6 the float32 Gram is PSD only to about
    sqrt(N) eps_f32 of its O(N) diagonal, which can make G_b + K_uu
    indefinite downstream; a float64 Gram of the stored W is PSD to float64
    rounding, and the M x M algebra after it runs in float64 too.

    State dim <= 3 with H = e1 only (``pallas_supported``): any other SDE
    raises ``ValueError``; callers check first, as in the JAX package."""
    if not pallas_supported(lgssm):
        raise ValueError("whiten_gram takes state dim <= 3 with H = e1 (pallas_supported)")
    f32 = torch.float32
    n = lgssm.num_steps
    A, Q = lgssm.A.to(f32).contiguous(), lgssm.Q.to(f32).contiguous()
    R = lgssm.R.to(f32).expand(n).contiguous()
    U = torch.as_tensor(U, device=A.device).to(f32).contiguous()
    if U.shape[0] != n:
        raise ValueError(f"whiten_gram: U has {U.shape[0]} rows for an {n}-step SSM")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (A, Q, R, U)):
        from gpar_at_scale_torch.ops.grad import WhitenGram

        return WhitenGram.apply(A, Q, R, U)
    G, logdet, _ = gram_forward(A, Q, R, U)
    return G, logdet
