"""Model-axis (tensor-parallel) sharding of the M pseudo-points.

Counterpart of ``gpar_at_scale_tpu/parallel/modelshard.py``.  Rank r of the
``"model"`` axis owns M/D of the pseudo-points (rows r M/D .. (r+1) M/D of
Z; an M that D does not divide raises ``ValueError``) and:

* builds its own K_fu slab (N, M/D), with no communication;
* whitens ``[y - m | K_fu,loc]`` through the temporal LGSSM: one gain pass
  (K1/K2 on y = 0, ``ops/grad.py::gain_pass``), then K3 over its M/D + 1
  columns (``ops/whiten.py::whiten_sweep``); float64 or sum-kernel SDEs
  take the tensor-code blocked filter;
* all-gathers the whitened slab (N, M) and forms the Gram [wy | W]^T
  [wy | W] in float64 (the same matrix on every rank, as the M x M algebra
  after it: K_uu, chol(G_b + K_uu), in float64).

The objective is differentiable.  The backward is the mixed-column route of
``ssm/blocked_grad.py`` with the ranks' columns as its chunks: the Gram's
cotangent is factored on the host as F diag(s) F^T (an eigendecomposition,
so any symmetric cotangent, the bound's and the negated bound's alike), the
raw columns U = [y - m | K_fu] are all-gathered, rank r scores the mixed
columns U F_k of its share of F's columns (K3 with means, K4a/K4b per chunk
of CHUNK columns on the kernels), and the partial cotangents of
(A, Q, R, U) are summed over the axis in one all-reduce.  Every input the
ranks share (the LGSSM, y, the output kernel's parameters, V, Z) gets its
whole cotangent on every rank: the pieces that feed a rank's own slab have
their cotangents summed over the axis (``distributed.sum_grads``).  On an
axis of size 1 every function is ``gp/dtc.py``'s, call for call.
"""

from __future__ import annotations

import numpy as np
import torch

from gpar_at_scale_torch.gp.dtc import (
    QU,
    DTCIntermediates,
    _lam_chol,
    _whiten_all,
    dtc_bound,
)
from gpar_at_scale_torch.kernels import Matern52
from gpar_at_scale_torch.parallel.distributed import (
    all_gather,
    all_reduce_sum,
    sum_grads,
)
from gpar_at_scale_torch.parallel.mesh import axis_group, axis_rank, axis_size, spans
from gpar_at_scale_torch.ssm.markov import LGSSM, lgssm_of
from gpar_at_scale_torch.utils.params import unpack_gpar
from gpar_at_scale_torch.utils.psd import cho_solve, cholesky_psd, default_jitter, solve_lower

_F32 = torch.float32
# Mixed columns per K3 sweep and suffix scan in the backward (the chunk of
# benchmarks/million_dtc.py --mixed-bwd=8).
CHUNK = 8


def _engine(lgssm: LGSSM) -> str:
    from gpar_at_scale_torch.ops.kalman import pallas_supported

    return "pallas" if lgssm.A.dtype == _F32 and pallas_supported(lgssm) else "blocked"


def _whiten_local(engine, A, Q, R, H, cols):
    """(W (N, B) whitened columns, log det Sigma in float64) of this rank's
    columns."""
    if engine == "pallas":
        from gpar_at_scale_torch.ops.grad import gain_pass
        from gpar_at_scale_torch.ops.whiten import whiten_sweep

        rows, S, _, _ = gain_pass(A, Q, R)
        _, W = whiten_sweep(rows, cols.contiguous(), A.shape[-1])
        return W, torch.log(S).double().sum()
    from gpar_at_scale_torch.ssm.blocked import blocked_filter

    res = blocked_filter(LGSSM(A=A, Q=Q, H=H, R=R), cols)
    return res.v / torch.sqrt(res.S)[:, None], torch.log(res.S).double().sum()


def _signed_factor(ct_G):
    """(F, s) with sym(ct_G) = F diag(s) F^T, s = +-1, from an
    eigendecomposition in float64 on the host: (M + 1)^2 numbers."""
    ct = np.asarray(ct_G.detach().cpu(), dtype=np.float64)
    lam, V = np.linalg.eigh(0.5 * (ct + ct.T))
    return V * np.sqrt(np.abs(lam)), np.where(lam < 0.0, -1.0, 1.0)


def _mixed_parts(engine, A, Q, R, H, U, F, s, ct_ld, cols, ld_here):
    """Partial (ct_A, ct_Q, ct_R, ct_U) of the mixed columns U F[:, cols]
    in chunks of CHUNK, plus the ct_ld terms if ``ld_here``."""
    dev = A.device
    if engine == "pallas":
        from gpar_at_scale_torch.ops.grad import gain_pass, whiten_bwd_ld_part, whiten_bwd_mixed_chunk

        gains = gain_pass(A, Q, R)
        chunk_fn = lambda Fk, ct: whiten_bwd_mixed_chunk(A, U, Fk, gains, ct)  # noqa: E731
        ld_fn = lambda: whiten_bwd_ld_part(A, ct_ld, gains)  # noqa: E731
    else:
        from gpar_at_scale_torch.ssm.blocked_grad import whiten_bwd_ld_part, whiten_bwd_mixed_chunk

        chunk_fn = lambda Fk, ct: whiten_bwd_mixed_chunk(A, Q, R, H, U, Fk, ct)  # noqa: E731
        ld_fn = lambda: whiten_bwd_ld_part(A, Q, R, H, ct_ld)  # noqa: E731
    acc = [torch.zeros_like(A), torch.zeros_like(Q), torch.zeros_like(R), torch.zeros_like(U)]
    if ld_here:
        for a, part in zip(acc, ld_fn()):
            a += part
    start, length = cols
    for j in range(start, start + length, CHUNK):
        k = slice(j, min(j + CHUNK, start + length))
        Fk = torch.as_tensor(F[:, k], dtype=A.dtype, device=dev)
        ct = torch.diag(torch.as_tensor(s[k], dtype=A.dtype, device=dev))
        for a, part in zip(acc, chunk_fn(Fk, ct)):
            a += part
    return acc


class _ModelShardedGram(torch.autograd.Function):
    """(G, log det Sigma) of [ym | K_fu] with K_fu's columns sharded over a
    group: ``Kfu_loc`` is this rank's slab.  A, Q, R (N, ...) and ym (N,)
    are the same on every rank and get whole cotangents; Kfu_loc gets its
    own."""

    @staticmethod
    def forward(ctx, A, Q, R, ym, Kfu_loc, H, group, rank, size, engine):
        cols = torch.cat([ym[:, None], Kfu_loc], dim=1)
        W, logdet = _whiten_local(engine, A, Q, R, H, cols)
        white = torch.cat([W[:, :1]] + all_gather(W[:, 1:].contiguous(), group), dim=1).double()
        ctx.group, ctx.rank, ctx.size, ctx.engine = group, rank, size, engine
        ctx.save_for_backward(A, Q, R, ym, Kfu_loc, H)
        return white.T @ white, logdet

    @staticmethod
    def backward(ctx, ct_G, ct_ld):
        A, Q, R, ym, Kfu_loc, H = ctx.saved_tensors
        U = torch.cat([ym[:, None]] + all_gather(Kfu_loc.contiguous(), ctx.group), dim=1)
        F, s = _signed_factor(ct_G)
        cols = spans(U.shape[1], ctx.size)[ctx.rank]
        parts = _mixed_parts(ctx.engine, A, Q, R, H, U, F, s, ct_ld, cols, ld_here=ctx.rank == 0)
        flat = all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]), ctx.group)
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        ct_A, ct_Q, ct_R, ct_U = out
        k = Kfu_loc.shape[1]
        ct_loc = ct_U[:, 1 + ctx.rank * k:1 + (ctx.rank + 1) * k]
        return ct_A, ct_Q, ct_R, ct_U[:, 0], ct_loc, None, None, None, None, None


def _check_m(mesh, Z, model_axis):
    m, d_ax = Z.shape[0], axis_size(mesh, model_axis)
    if m % d_ax:
        raise ValueError(f"M={m} must divide the '{model_axis}' axis size {d_ax}")
    return m, d_ax


def modelsharded_whiten(
    mesh,
    out_kernel_params,
    lgssm: LGSSM,
    V,
    y,
    Z,
    *,
    out_family=Matern52,
    mean=0.0,
    uu_ridge="auto",
    model_axis: str = "model",
) -> DTCIntermediates:
    """DTC Gram intermediates with the M axis of Z sharded over
    ``model_axis``.  ``out_kernel_params`` = (out_l, out_sigma); Z (M, D) is
    passed whole on every rank (``place_modelsharded``) and each rank takes
    its rows.  The scan engine: the kernels for a float32 SDE they take,
    else the tensor-code blocked filter; the Gram and K_uu's factor in
    float64, as ``gp/dtc.py``'s scan engines."""
    ol, ov = out_kernel_params
    Z = torch.as_tensor(Z)
    m, d_ax = _check_m(mesh, Z, model_axis)
    engine = _engine(lgssm)
    dtype = lgssm.A.dtype
    out_k = out_family(lengthscale=ol, variance=ov**2)
    V, y = torch.as_tensor(V).to(dtype), torch.as_tensor(y).to(dtype)
    if d_ax == 1:
        return _whiten_all(out_k, V, Z.to(dtype), lgssm, y, mean, uu_ridge, engine)
    group, rank = axis_group(mesh, model_axis), axis_rank(mesh, model_axis)
    n = lgssm.num_steps
    k = m // d_ax
    shared = [sum_grads(x, group) if torch.is_tensor(x) else x for x in (ol, ov, V, Z)]
    ol_s, ov_s, V_s, Z_s = shared
    Kfu_loc = out_family(lengthscale=ol_s, variance=ov_s**2)(V_s, Z_s[rank * k:(rank + 1) * k].to(dtype))
    ym = (y - mean).to(dtype)
    R = lgssm.R.to(dtype).expand(n)
    G, logdet = _ModelShardedGram.apply(
        lgssm.A, lgssm.Q, R, ym, Kfu_loc.to(dtype), lgssm.H.to(dtype), group, rank, d_ax, engine)
    Kuu = out_k(Z.to(dtype), Z.to(dtype))
    if isinstance(uu_ridge, str) and uu_ridge == "auto":
        uu_ridge = lgssm.R.mean()
    if uu_ridge is not None:
        Kuu = Kuu + uu_ridge * torch.eye(m, dtype=Kuu.dtype, device=Kuu.device)
    L_uu = cholesky_psd(Kuu.double(), default_jitter(Kuu.dtype))
    return DTCIntermediates(aa=G[0, 0], g=G[1:, 0], Gb=G[1:, 1:], L_uu=L_uu, logdet_noise=logdet)


def dtc_objective_modelsharded(mesh, out_kernel_params, lgssm: LGSSM, V, y, Z, *,
                               out_family=Matern52, mean=0.0, uu_ridge="auto",
                               model_axis: str = "model"):
    """The DTC bound (``gp.dtc.dtc_objective``'s P-form) with M
    model-sharded; the same value on every rank, differentiable."""
    inter = modelsharded_whiten(mesh, out_kernel_params, lgssm, V, y, Z, out_family=out_family,
                                mean=mean, uu_ridge=uu_ridge, model_axis=model_axis)
    return dtc_bound(inter, lgssm.num_steps)


def compute_q_u_modelsharded(mesh, out_kernel_params, lgssm: LGSSM, V, y, Z, *,
                             out_family=Matern52, mean=0.0, uu_ridge="auto",
                             model_axis: str = "model") -> QU:
    """Model-sharded q(u) (``gp.dtc.compute_q_u``'s)."""
    inter = modelsharded_whiten(mesh, out_kernel_params, lgssm, V, y, Z, out_family=out_family,
                                mean=mean, uu_ridge=uu_ridge, model_axis=model_axis)
    L_D = _lam_chol(inter)
    m_eps = cho_solve(L_D, solve_lower(inter.L_uu, inter.g))
    return QU(m_eps=m_eps, L_D=L_D, L_uu=inter.L_uu, Z=torch.as_tensor(Z))


def make_modelsharded_nlml(mesh, *, out_family=Matern52, time_family=Matern52,
                           dtype=torch.float32, model_axis: str = "model"):
    """Negative DTC objective as a function of (params, t, V, y, Z) with M
    model-sharded: ``parallel.sharded.make_dtc_nlml``'s, 5-parameter pack."""

    def nlml(params, t, V, y, Z):
        tl, ts, ol, osig, ns = unpack_gpar(params)
        lgssm = lgssm_of(time_family(lengthscale=tl, variance=ts**2), t, ns**2, dtype)
        return -dtc_objective_modelsharded(mesh, (ol, osig), lgssm, V, y, Z, out_family=out_family,
                                           uu_ridge=ns**2, model_axis=model_axis)

    return nlml


def place_modelsharded(mesh, Z, model_axis: str = "model"):
    """Z as the model-sharded functions take it: whole on every rank (it is
    M x D; each rank's slab is its rows r M/D .. (r+1) M/D, and K_uu needs
    all of them).  Raises ``ValueError`` when the axis does not divide M."""
    Z = torch.as_tensor(Z)
    _check_m(mesh, Z, model_axis)
    return Z
