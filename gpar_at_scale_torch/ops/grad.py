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
  information matrix N; the elements before it and the scores after it
  (r ctsym r^T, u ctsym, N A P) are K5a and K5b.  The JAX package runs this
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

The adjoint's elements and scores around the suffix scan are two kernels
of their own (``csrc/adjoint.cu``): K5a (``adjoint_elements``: C, b, W)
and K5b (``adjoint_scores``: ct_A, ct_Q, ct_R, ct_U from the scanned r and
N).  They replace no ``pallas_call`` -- the JAX package's VJP glue is fused
by XLA -- and take the place of the batched 3 x 3 products and elementwise
passes of ``ssm/blocked_grad.py::whiten_bwd_elements`` and
``whiten_bwd_scores``, which stay as their plain versions (the CPU path and
the check on the card) and as the tensor-code engines' backward.

The backward of each of the three is the span ``gpar.whiten_gram.backward``
(``utils/observability.py``).
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ops.build import CudaKernel, aligned16, ptr, require_f32
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

K5A = CudaKernel(
    "K5a adjoint_elements", "adjoint", "adjoint_elements",
    "no pallas_call: gpar_at_scale_tpu/ops/pallas_grad.py's VJP, fused by XLA",
)
K5B = CudaKernel(
    "K5b adjoint_scores", "adjoint", "adjoint_scores",
    "no pallas_call: gpar_at_scale_tpu/ops/pallas_grad.py's VJP, fused by XLA",
)
# K5b holds one step's rows of r, m and u in shared memory at the least.
ADJOINT_MAX_COLUMNS = 4096


def _check_adjoint(name, A, aux, H):
    """(n, d, B) of the adjoint's inputs; raises on what K5a/K5b do not
    take: state dim above 3, an emission row H other than e1, anything but
    contiguous float32 on one device, or mismatched shapes."""
    e, S, K, m, P = aux
    require_f32(name, A, e, S, K, m, P)
    n, d = A.shape[0], A.shape[-1]
    if not 1 <= d <= 3 or A.shape != (n, d, d) or P.shape != (n, d, d):
        raise ValueError(f"{name}: A, P must be (n, d, d) with d <= 3, got {tuple(A.shape)}, "
                         f"{tuple(P.shape)}")
    B = e.shape[-1] if e.ndim == 2 else 0
    if e.shape != (n, B) or S.shape != (n,) or K.shape != (n, d) or m.shape != (n, d, B):
        raise ValueError(f"{name}: e, S, K, m must be ({n}, B), ({n},), ({n}, {d}), ({n}, {d}, B); "
                         f"got {[tuple(x.shape) for x in (e, S, K, m)]}")
    if not 1 <= B <= ADJOINT_MAX_COLUMNS:
        raise ValueError(f"{name}: {B} columns, the kernels take 1 to {ADJOINT_MAX_COLUMNS}")
    if H is not None:
        h = H.detach().cpu()
        if h.shape != (d,) or h[0] != 1.0 or bool((h[1:] != 0.0).any()):
            raise ValueError(f"{name}: the kernels take the emission row H = e1 only")
    return n, d, B


def _plain_row(A):
    """H = e1 for the plain versions, on CPU tensors; None on the card,
    where K5a/K5b need no H."""
    return None if A.is_cuda else _e1(A.shape[-1], A)


def adjoint_elements(A, aux, H=None):
    """K5a: the suffix-scan elements (C (n, d, d), b (n, d, B), W (n, d, d))
    of the adjoint recursions from A (n, d, d) and the forward's aux =
    (e, S, K, m, P) (``ssm.blocked_grad.whiten_bwd_elements`` with H = e1).
    float32, d <= 3; ``H``, where a caller has one, must be e1.  Launches
    on CUDA tensors, runs the plain version on CPU tensors."""
    n, d, B = _check_adjoint("adjoint_elements", A, aux, H)
    if not A.is_cuda:
        return whiten_bwd_elements(A, _e1(d, A) if H is None else H, aux)
    e, S, K = aux[:3]
    C, W = (torch.empty((n, d, d), dtype=_F32, device=A.device) for _ in range(2))
    b = torch.empty((n, d, B), dtype=_F32, device=A.device)
    K5A(d, ptr(A), ptr(K), ptr(S), ptr(e), n, B, ptr(C), ptr(b), ptr(W))
    return C, b, W


def adjoint_scores(A, aux, r, Nmat, ct_G, ct_ld, H=None):
    """K5b: (ct_A (n, d, d), ct_Q (n, d, d), ct_R (n,), ct_U (n, B)) from the
    scanned adjoints r (n, d, B) and N (n, d, d), the Gram's cotangent ct_G
    (B, B) and the log-determinant's ct_ld, both cast to float32 first
    (``ssm.blocked_grad.whiten_bwd_scores`` with H = e1).  float32, d <= 3;
    ``H``, where a caller has one, must be e1.  Launches on CUDA tensors,
    runs the plain version on CPU tensors."""
    n, d, B = _check_adjoint("adjoint_scores", A, aux, H)
    require_f32("adjoint_scores", A, r, Nmat)
    if r.shape != (n, d, B) or Nmat.shape != (n, d, d):
        raise ValueError(f"adjoint_scores: r, N must be ({n}, {d}, {B}), ({n}, {d}, {d}); got "
                         f"{tuple(r.shape)}, {tuple(Nmat.shape)}")
    ct_G = torch.as_tensor(ct_G, device=A.device).to(_F32)
    if ct_G.shape != (B, B):
        raise ValueError(f"adjoint_scores: ct_G must be ({B}, {B}), got {tuple(ct_G.shape)}")
    if not A.is_cuda:
        return whiten_bwd_scores(A, _e1(d, A) if H is None else H, aux, r, Nmat, ct_G, ct_ld)
    # sym(ct_G) with its rows padded to whole 16-byte units
    ctsym = torch.nn.functional.pad(0.5 * (ct_G + ct_G.T), (0, -B % 4)).contiguous()
    if torch.is_tensor(ct_ld):
        ld = ct_ld.detach().to(device=A.device, dtype=_F32).reshape(1)
    else:  # a fill on the device, not a copy from the host
        ld = torch.full((1,), float(ct_ld), dtype=_F32, device=A.device)
    A, e, S, K, m, P, r, Nmat = (aligned16(x) for x in (A, *aux, r, Nmat))
    ct_A, ct_Q = (torch.empty((n, d, d), dtype=_F32, device=A.device) for _ in range(2))
    ct_R = torch.empty(n, dtype=_F32, device=A.device)
    ct_U = torch.empty((n, B), dtype=_F32, device=A.device)
    K5B(d, ptr(A), ptr(P), ptr(K), ptr(S), ptr(e), ptr(m), ptr(r), ptr(Nmat), ptr(ctsym), ptr(ld),
        n, B, ptr(ct_A), ptr(ct_Q), ptr(ct_R), ptr(ct_U))
    return ct_A, ct_Q, ct_R, ct_U


def _bwd(A, aux, ct_G, ct_ld):
    """(ct_A, ct_Q, ct_R, ct_U): the elements on K5a, one suffix scan on
    K4a/K4b, the scores on K5b."""
    aux = tuple(x.contiguous() for x in aux)
    H = _plain_row(A)
    C, b, W = adjoint_elements(A, aux, H)
    r, Nmat = suffix_scan(C, b, W)
    return adjoint_scores(A, aux, r, Nmat, ct_G, ct_ld, H)


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
    one K3 sweep with means on the shared ``gains`` (``gain_pass``), the
    elements on K5a, one K-column suffix scan with W = 0 on K4a/K4b and the
    scores on K5b, scored at the chunk's Gram
    cotangent ``ct_chunk`` (K, K) (-I if None).  float32, H = e1."""
    rows, S, K, P = gains
    Fk = Fk.to(_F32)
    _, alpha, m = whiten_sweep(rows, (U @ Fk).contiguous(), A.shape[-1], want_means=True)
    aux = (alpha * torch.sqrt(S)[:, None], S, K, m, P)
    H = _plain_row(A)
    C, b, W = adjoint_elements(A, aux, H)
    r, Nmat = suffix_scan(C, b, torch.zeros_like(W))
    if ct_chunk is None:
        ct_chunk = -torch.eye(Fk.shape[1], dtype=_F32, device=A.device)
    ct_A, ct_Q, ct_R, ct_Ut = adjoint_scores(A, aux, r, Nmat, ct_chunk, 0.0, H)
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
