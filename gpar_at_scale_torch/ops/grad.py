"""Differentiable kernel path: the closed-form disturbance-smoother VJPs (K5).

Counterpart of ``gpar_at_scale_tpu/ops/pallas_grad.py``.  The CUDA scans
are not traced by autograd; the gradient of what they compute comes in
closed form from the filter's own per-step outputs, through the adjoint
recursions of ``ssm/blocked_grad.py`` (see its docstring for the algebra),
with the suffix scan on the card (``ops/smoother.py``, K4a/K4b):

* ``LgssmLoglik`` -- ll = log N(y | 0, Sigma(A, Q, R)) of one series.
  Forward: K1, phase 2, K2 with per-step moments.  Backward: the adjoint
  elements, one single-column suffix scan (K4a, R2, K4b) for (r, N), then
  the scores -> (dA, dQ, dR, dy) x ct.
* ``WhitenGram`` -- (G, logdet) with G = U^T Sigma^-1 U of the M + 1 DTC
  columns U = [y - m | K_fu].  Forward: the y = 0 gain pass (K1/K2) and
  K3 over U, which also writes every column's filtered mean; G is formed
  in float64.  Backward: one suffix scan with E = C, g = b (n, d, M + 1),
  L = W gives both the adjoint r of every column and the shared
  information matrix N; the contractions of the scores (r ctsym r^T,
  u ctsym, N A P) are plain batched products.  The JAX package runs this
  backward as three XLA associative scans.
* ``MixedWhitenGram`` -- the same (G, logdet) with the mixed-column
  backward of ``ssm/blocked_grad.py``: the y = 0 gain pass once (K1/K2),
  then per chunk of K mixed columns U F_k one K3 sweep with means and one
  K-column suffix scan (K4a/K4b), and one single-column scan for the ct_ld
  terms.  Its backward holds K columns at a time where ``WhitenGram``'s
  holds (N, d, M + 1) means and adjoints.

Everything on the O(N) side is float32; cotangents that arrive in float64
from the M x M algebra are cast to float32 first.  Both take state dim
<= 3 with H = e1 (one Matern block), as the kernels do; their callers send
every other SDE to the associative-scan engine (``logpdf_markov_pallas``
here, ``gp/dtc.py::_whiten_all`` for the Gram).

The backward of each of the three is the span ``gpar.whiten_gram.backward``
(``utils/observability.py``).
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ops.kalman import _e1, decorrelate_blocked, pallas_supported
from gpar_at_scale_torch.ops.smoother import suffix_scan
from gpar_at_scale_torch.ops.whiten import gain_rows, gram_forward, whiten_sweep
from gpar_at_scale_torch.ssm.blocked_grad import (
    cotangent_factor,
    whiten_bwd_elements,
    whiten_bwd_scores,
)
from gpar_at_scale_torch.ssm.markov import LGSSM, lgssm_of
from gpar_at_scale_torch.utils.observability import span

_F32 = torch.float32


def _bwd(A, aux, ct_G, ct_ld):
    """(ct_A, ct_Q, ct_R, ct_U) through one suffix scan on K4a/K4b."""
    H = _e1(A.shape[-1], A)
    C, b, W = whiten_bwd_elements(A, H, aux)
    r, Nmat = suffix_scan(C, b, W)
    return whiten_bwd_scores(A, H, aux, r, Nmat, ct_G, ct_ld)


class LgssmLoglik(torch.autograd.Function):
    """log N(y | 0, Sigma(A, Q, R)) of one float32 series through K1/K2,
    with its gradient in (A, Q, R, y) through K4a/K4b."""

    @staticmethod
    def forward(ctx, A, Q, R, y):
        lg = LGSSM(A=A, Q=Q, H=_e1(A.shape[-1], A), R=R, e1=True)
        ll, alpha, _, S, K, m, P = decorrelate_blocked(lg, y, return_full=True)
        ctx.save_for_backward(A, alpha, S, K, m, P)
        return ll

    @staticmethod
    def backward(ctx, ct):
        with span("gpar.whiten_gram.backward"):
            A, alpha, S, K, m, P = ctx.saved_tensors
            aux = ((alpha * torch.sqrt(S))[:, None], S, K, m[:, :, None], P)
            half = torch.full((1, 1), -0.5, dtype=_F32, device=A.device)
            dA, dQ, dR, dU = _bwd(A, aux, half, -0.5)  # ll's = the Gram's at -1/2
            ct = ct.to(_F32)
            return ct * dA, ct * dQ, ct * dR, ct * dU[:, 0]


def lgssm_loglik(A, Q, R, y):
    """Differentiable log-likelihood of one series through the kernels;
    float32, A, Q (N, d, d), R, y (N,)."""
    return LgssmLoglik.apply(*(x.to(_F32).contiguous() for x in (A, Q, R, y)))


def logpdf_markov_pallas(kernel, t, noise_var, y):
    """Kernel hyperparameters -> discretization (autograd) -> kernel-path
    log-likelihood (closed-form VJP), float32; the gaps are taken in t's
    precision (``lgssm_of``), which at N = 10^7 steps of 1e-3 needs a
    float64 t.  Dispatch, by the SDE's shape alone (``pallas_supported``),
    as in the JAX package: sum-kernel SDEs take the associative-scan engine
    (``ssm/pkalman.py::parallel_logpdf``, autograd) and launch nothing."""
    t = torch.as_tensor(t)
    lg = lgssm_of(kernel, t, noise_var, _F32)
    y = torch.as_tensor(y, device=t.device)
    if not pallas_supported(lg):
        from gpar_at_scale_torch.ssm.pkalman import parallel_logpdf

        return parallel_logpdf(lg, y.to(_F32))
    return lgssm_loglik(lg.A, lg.Q, lg.R.expand(lg.num_steps), y)


class WhitenGram(torch.autograd.Function):
    """(G, logdet) = (U^T Sigma^-1 U in float64, log det Sigma) of float32
    (A, Q, R (N,), U (N, B)) through K1/K2/K3, with the gradient in
    (A, Q, R, U) through K4a/K4b."""

    @staticmethod
    def forward(ctx, A, Q, R, U):
        G, logdet, aux = gram_forward(A, Q, R, U, want_aux=True)
        ctx.save_for_backward(A, *aux)
        return G, logdet

    @staticmethod
    def backward(ctx, ct_G, ct_ld):
        with span("gpar.whiten_gram.backward"):
            A, *aux = ctx.saved_tensors
            return _bwd(A, tuple(aux), ct_G, ct_ld)


def gain_pass(A, Q, R):
    """The y = 0 pass on K1/K2 that every column shares: (gain rows for K3,
    S (N,), K (N, d), P (N, d, d))."""
    n, d = A.shape[0], A.shape[-1]
    lg = LGSSM(A=A, Q=Q, H=_e1(d, A), R=R, e1=True)
    _, _, _, S, K, _, P = decorrelate_blocked(lg, A.new_zeros(n), return_full=True)
    return gain_rows(A, S, K), S, K, P


def whiten_bwd_mixed_chunk(A, U, Fk, gains, ct_chunk=None):
    """The kernel route of ``ssm.blocked_grad.whiten_bwd_mixed_chunk``:
    (ct_A, ct_Q, ct_R, ct_U) of the mixed columns U F_k (Fk (B, K)) from
    one K3 sweep with means on the shared ``gains`` (``gain_pass``) and one
    K-column suffix scan with W = 0 on K4a/K4b, scored at the chunk's Gram
    cotangent ``ct_chunk`` (K, K) (-I if None).  float32, H = e1."""
    rows, S, K, P = gains
    Fk = Fk.to(_F32)
    _, alpha, m = whiten_sweep(rows, (U @ Fk).contiguous(), A.shape[-1], want_means=True)
    aux = (alpha * torch.sqrt(S)[:, None], S, K, m, P)
    H = _e1(A.shape[-1], A)
    C, b, W = whiten_bwd_elements(A, H, aux)
    r, Nmat = suffix_scan(C, b, torch.zeros_like(W))
    if ct_chunk is None:
        ct_chunk = -torch.eye(Fk.shape[1], dtype=_F32, device=A.device)
    ct_A, ct_Q, ct_R, ct_Ut = whiten_bwd_scores(A, H, aux, r, Nmat, ct_chunk, 0.0)
    return ct_A, ct_Q, ct_R, ct_Ut @ Fk.T


def whiten_bwd_ld_part(A, ct_ld, gains):
    """The kernel route of ``ssm.blocked_grad.whiten_bwd_ld_part``:
    (ct_A, ct_Q, ct_R) of the ct_ld terms, one single-column suffix scan
    with W on the shared ``gains``."""
    _, S, K, P = gains
    n, d = K.shape
    aux = (A.new_zeros((n, 1)), S, K, A.new_zeros((n, d, 1)), P)
    ct_A, ct_Q, ct_R, _ = _bwd(A, aux, A.new_zeros((1, 1)), ct_ld)
    return ct_A, ct_Q, ct_R


class MixedWhitenGram(torch.autograd.Function):
    """``WhitenGram``'s (G, logdet) with the mixed-column backward over
    chunks of ``chunk`` columns (the JAX package's ``--mixed-bwd``).  The
    backward needs a negative semidefinite sym(ct_G), as the DTC bound
    gives (``cotangent_factor``)."""

    @staticmethod
    def forward(ctx, A, Q, R, U, chunk):
        G, logdet, _ = gram_forward(A, Q, R, U)
        ctx.save_for_backward(A, Q, R, U)
        ctx.chunk = int(chunk)
        return G, logdet

    @staticmethod
    def backward(ctx, ct_G, ct_ld):
        with span("gpar.whiten_gram.backward"):
            A, Q, R, U = ctx.saved_tensors
            F = torch.as_tensor(cotangent_factor(ct_G), dtype=_F32, device=A.device)
            gains = gain_pass(A, Q, R)
            ct_A, ct_Q, ct_R = whiten_bwd_ld_part(A, ct_ld, gains)
            ct_U = torch.zeros_like(U)
            for j in range(0, F.shape[1], ctx.chunk):
                parts = whiten_bwd_mixed_chunk(A, U, F[:, j:j + ctx.chunk], gains)
                for acc, part in zip((ct_A, ct_Q, ct_R, ct_U), parts):
                    acc += part
            return ct_A, ct_Q, ct_R, ct_U, None
