"""Many-column Kalman whitening on the card: kernel K3, the DTC hot path.

Counterpart of ``gpar_at_scale_tpu/ops/pallas_whiten.py::
pallas_whiten_columns`` and of the forward half of
``gpar_at_scale_tpu/ops/pallas_grad.py::whiten_gram``.  The covariance and
gain recursion of the filter does not depend on the observations, so K1/K2
run it once with y = 0 (``ops/kalman.py``) and hand over one gain row per
step, ``[S, log S, mask, K (d), A[0, :] (d), M = (I - K H) A (d*d)]``.  K3
(``csrc/whiten.cu``) then runs only the affine mean recursion, one thread per
column:

    v_k = y_k - A_k[0, :] . m_{k-1},   alpha_k = v_k / sqrt(S_k)
    m_k = M_k m_{k-1} + K_k y_k,       ll -= (log 2 pi + log S_k + alpha_k^2) / 2

``whiten_sweep`` is K3's wrapper.  Its plain version (``whiten_sweep_plain``)
computes the same recursion as a blocked affine scan over time, vectorised
over blocks and columns.

This slice has no gradient: the backward pass of ``whiten_gram`` is the
training slice's (ROADMAP), so inputs that require grad raise.
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ops.build import CudaKernel, ptr, require_f32
from gpar_at_scale_torch.ops.kalman import decorrelate_blocked
from gpar_at_scale_torch.ssm.blocked import _pad_block, _scan, _unblock, num_blocks_for
from gpar_at_scale_torch.ssm.markov import LGSSM

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


def whiten_sweep_plain(gains, Y, d):
    """K3's plain version: (ll (B,), alpha (N, B)) by a blocked affine scan.

    Phase 1 composes each block's affine maps m -> M m + K y; an exclusive
    prefix over the block maps gives the mean entering every block; phase 3
    replays each block and emits alpha and ll."""
    n, B = Y.shape
    nb = num_blocks_for(n)
    T = -(-n // nb)
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
    ll = Y.new_zeros((nb, B))
    for t in range(T):
        msk = mask[t][:, None]
        v = Yb[t] - (A0[t][:, None, :] @ m)[:, 0, :]
        a = v * torch.rsqrt(S[t])[:, None] * msk
        m_new = M[t] @ m + K[t][:, :, None] * Yb[t][:, None, :]
        m = torch.where(live[t][:, None, None], m_new, m)
        ll = ll - 0.5 * msk * (_LOG_2PI + logS[t][:, None] + a * a)
        alpha[t] = a
    return ll.double().sum(0).to(Y.dtype), _unblock(alpha, n)


def whiten_sweep(gains, Y, d: int):
    """K3: (ll (B,), alpha (N, B)) of the columns of Y (N, B) given the gain
    rows (N, 3 + 2d + d*d).  Launches on CUDA tensors, runs the plain
    version on CPU tensors."""
    require_f32("whiten_sweep", gains, Y)
    n, B = Y.shape
    if not 1 <= d <= 3 or gains.shape != (n, 3 + 2 * d + d * d):
        raise ValueError(f"whiten_sweep: gains {tuple(gains.shape)} do not fit d={d}, N={n}")
    if not Y.is_cuda:
        return whiten_sweep_plain(gains, Y, d)
    alpha = torch.empty_like(Y)
    ll = torch.empty(B, dtype=Y.dtype, device=Y.device)
    K3(d, ptr(gains), ptr(Y), n, B, ptr(alpha), ptr(ll))
    return ll, alpha


def _no_grad_inputs(*tensors):
    if torch.is_grad_enabled() and any(torch.is_tensor(x) and x.requires_grad for x in tensors):
        raise NotImplementedError(
            "whitening through the CUDA kernels has no backward pass yet; "
            "gradients come with the training slice (ROADMAP)"
        )


def whiten_columns(lgssm: LGSSM, Y):
    """Batched whitening of Y (N,) or (N, B) -> (ll (B,), alpha (N, B), logdet).

    float32, state dim <= 3, H = e1.  The gains come from K1/K2 run on
    y = 0; K3 then sweeps the B columns.  Tensors on the card launch the
    kernels; tensors on the CPU take the plain versions."""
    _no_grad_inputs(lgssm.A, lgssm.Q, lgssm.R, Y)
    A = lgssm.A.to(torch.float32).contiguous()
    Y = torch.as_tensor(Y, device=A.device).to(torch.float32)
    if Y.ndim == 1:
        Y = Y[:, None]
    Y = Y.contiguous()
    n, d = A.shape[0], A.shape[-1]
    if Y.shape[0] != n:
        raise ValueError(f"whiten_columns: Y has {Y.shape[0]} rows for an {n}-step SSM")
    _, _, logdet, S, K, _, _ = decorrelate_blocked(
        lgssm, torch.zeros(n, dtype=torch.float32, device=A.device), return_full=True
    )
    ll, alpha = whiten_sweep(gain_rows(A, S, K), Y, d)
    return ll, alpha, logdet


def whiten_gram(lgssm: LGSSM, U):
    """(G, logdet) with G = U^T Sigma_y^-1 U, forward only.

    The whitened columns W come from the kernels in float32; G = W^T W is
    formed in float64.  At N = 1e6 the float32 Gram is PSD only to about
    sqrt(N) eps_f32 of its O(N) diagonal, which can make G_b + K_uu
    indefinite downstream; a float64 Gram of the stored W is PSD to float64
    rounding, and the M x M algebra after it runs in float64 too."""
    _, W, logdet = whiten_columns(lgssm, U)
    W = W.double()
    return W.T @ W, logdet.double()
