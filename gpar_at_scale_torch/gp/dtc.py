"""DTC pseudo-point sparse GP with temporal structured noise.

Counterpart of ``gpar_at_scale_tpu/gp/dtc.py``.  The conditional GP is
f = f_x + f_t: f_x over the previous outputs is approximated with M inducing
points, and f_t is exact through the LGSSM, whose covariance
Sigma_y = K_time + s2 I is a structured noise matrix inside the DTC bound.
With L = chol(K_uu) and W any square root of Sigma_y^-1,

    alpha = W (y - m),  beta = W K_fu,  A = L^-1 beta^T,  Lam = A A^T + I
    dtc   = -1/2 [ N log 2pi + log det Sigma_y + log det Lam
                   + |alpha|^2 - |chol(Lam)^-1 A alpha|^2 ]

and q(eps) = N(m_eps, D^-1) with D = A A^T + I, m_eps = D^-1 A alpha; the
predictive loads f_x = K_*u L^-T eps.

Whitening engines (``filter_fn``), each differentiable in the
hyperparameters:

* ``"dense"`` -- chol(Sigma_y) and one triangular solve with M+1
  right-hand sides, for N <= ``DENSE_N_MAX``; autograd.  With
  ``engine.pallas_dense`` switched on (``utils/psd.py``) one K6a launch
  factorizes Sigma_y and whitens all M+1 columns, as the JAX package's
  fused Pallas kernel does, and every factorization and solve the JAX
  package sends to its kernels goes through K6a-c (chol(P) and chol(Lam)
  take ``torch.linalg``, as they take ``jnp.linalg`` there).
* ``"pallas"`` -- the CUDA blocked-scan kernels K1/K2/K3 forward and the
  suffix-scan kernels K4a/K4b backward (``ops/whiten.py::whiten_gram``,
  ``ops/grad.py``); the name is the JAX package's, so one configuration
  drives both.  SDEs the kernels cannot take (``ops.kalman.
  pallas_supported``: state dim > 3 or H != e1, i.e. sum kernels) go to the
  associative-scan filter instead, as in the JAX package; the choice is
  made from the SDE's shape before anything is launched.
* ``"blocked"`` -- the same closed-form gradient over the tensor-code
  blocked filter (``ssm/blocked_grad.py``), for any state dim and emission
  row, in the working precision.
* a callable ``(lgssm, Y) -> FilterResult`` -- e.g. the sequential
  ``ssm.kalman.kalman_filter`` or the associative-scan
  ``ssm.pkalman.parallel_filter``; autograd.  A callable with a ``gram``
  method forms the Gram through it: the time-sharded filter
  (``parallel/seqshard.py::ShardedFilter``).
* ``None`` -- auto: ``"dense"`` when (time_kernel, t) are given and
  N <= DENSE_N_MAX, the kernel path above that.  The JAX package picks its
  XLA ``"blocked"`` engine there because its TPU compile service stalled on
  the kernel path; here ``"blocked"`` is tensor code, bound by launches.

Every engine but the dense one forms the whitened Gram in float64 and
runs the M x M algebra after it in float64, so they return float64
intermediates.  The JAX package keeps the filter engines' Gram in the
working precision; in float32 on an H100, with the Gram in float32 the
associative engine missed the float64 gradient of a chain conditional by
1% on its small components at N = 1e5 and could not factor G_b + K_uu at
N = 1e6.  The dense engine stays
in the working precision, as in the JAX package: a float32 factorization
that fails there raises, and the L-BFGS loop (``inference/optimize.py``)
treats that point as outside the objective's domain, as optax's line
search treats the NaN the JAX package gets there.

``predict_scaled`` has no ``smooth_fn`` argument: the port dispatches on
N_all alone.  ``predict_scaled_batch`` is its analytic predictive for a
batch of parameter sets on both branches, the scan branch's series laid
end to end through the kernels once (the JAX package vmaps
``predict_scaled``).  The iid-noise sparse GP (``dtc_objective_iid``,
``titsias_elbo``, ``predict_sparse_iid``) factors and solves through
``utils/psd.py``, so it takes K6a-c under ``engine.pallas_dense``.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from gpar_at_scale_torch.kernels.base import Kernel, _as_2d
from gpar_at_scale_torch.ssm.kalman import kalman_filter
from gpar_at_scale_torch.ssm.markov import LGSSM, lgssm_of
from gpar_at_scale_torch.utils.observability import host_sync, span
from gpar_at_scale_torch.utils.psd import (
    _pallas_dense_ok,
    _raise_on_info,
    cho_solve,
    chol_solve,
    chol_solve_ex,
    cholesky_psd,
    default_jitter,
    logdet_from_chol,
    solve_lower,
    solve_upper,
)

_LOG_2PI = 1.8378770664093453

# Largest N for which the auto dispatch materializes the dense N x N temporal
# covariance (the JAX package's bound).
DENSE_N_MAX = 2048


class DTCIntermediates(NamedTuple):
    """Whitened-Gram quantities shared by the objective and q(u)."""

    aa: torch.Tensor  # scalar (y-m)^T Sigma^-1 (y-m)
    g: torch.Tensor  # (M,)   K_fu^T Sigma^-1 (y-m)
    Gb: torch.Tensor  # (M, M) K_fu^T Sigma^-1 K_fu
    L_uu: torch.Tensor  # (M, M) chol(K_uu)
    logdet_noise: torch.Tensor  # scalar, log det Sigma_y


def _gram_from_white(white):
    """(N, M+1) whitened columns [alpha | beta] -> (aa, g, Gb)."""
    alpha, beta = white[:, 0], white[:, 1:]
    return alpha @ alpha, beta.T @ alpha, beta.T @ beta


def whiten_ex(Sigma, batch):
    """(L^-1 batch, log det Sigma, info) with L = chol(Sigma) for Sigma
    (..., N, N), batch (..., N, k): under the dense switch one K6a launch
    for the whole batch, else ``torch.linalg``; the factorization's info
    word (0, or the first pivot that failed, plus one) instead of a raise."""
    if _pallas_dense_ok(Sigma, batch):
        _, white, logdet, info = chol_solve_ex(Sigma, batch)
        return white, logdet, info
    L, info = torch.linalg.cholesky_ex(Sigma)
    return solve_lower(L, batch), logdet_from_chol(L), info


def dense_whiten(time_kernel: Kernel, t, R, batch):
    """Dense whitening: (L^-1 batch, log det Sigma_y) with
    L = chol(K_time + diag(R)); under the dense switch one K6a launch
    (the JAX package's ``_whiten_all``, ``chol_solve(Sigma, batch)``).
    Raises if Sigma_y is not positive definite."""
    t = t.to(batch.dtype)
    R = torch.as_tensor(R, dtype=batch.dtype, device=t.device).expand(t.shape[0])
    white, logdet, info = whiten_ex(time_kernel(t[:, None], t[:, None]) + torch.diag(R), batch)
    _raise_on_info(info)
    return white, logdet


def _whiten_all(
    out_kernel: Kernel,
    V,
    Z,
    lgssm: LGSSM,
    y,
    mean,
    uu_ridge,
    filter_fn=None,
    *,
    time_kernel=None,
    t=None,
) -> DTCIntermediates:
    """Whiten [y - mean | K_fu] through Sigma_y and reduce to Gram form.

    uu_ridge: ridge added to K_uu before factorization; ``"auto"`` uses
    mean(lgssm.R), the observation noise (see the JAX package)."""
    V, Z = _as_2d(V), _as_2d(Z)
    n, m = y.shape[0], Z.shape[0]
    with span("gpar.output_kernel"):
        Kfu = out_kernel(V, Z)
        Kuu = out_kernel(Z, Z)
        if isinstance(uu_ridge, str) and uu_ridge == "auto":
            uu_ridge = lgssm.R.mean()
        if uu_ridge is not None:
            Kuu = Kuu + uu_ridge * torch.eye(m, dtype=Kuu.dtype, device=Kuu.device)
        batch = torch.cat([(y - mean)[:, None], Kfu], dim=1)  # (N, M+1)

    if filter_fn is None and time_kernel is not None:
        filter_fn = "dense" if n <= DENSE_N_MAX else "pallas"

    if filter_fn == "dense":
        if time_kernel is None or t is None:
            raise ValueError("dense whitening requires time_kernel and t")
        with span("gpar.whiten_gram"):
            white, logdet_noise = dense_whiten(time_kernel, t, lgssm.R, batch)
            aa, g, Gb = _gram_from_white(white)
        with span("gpar.bound"):
            L_uu = cholesky_psd(Kuu)
    else:
        with span("gpar.whiten_gram"):
            G, logdet_noise = _scan_gram(filter_fn, lgssm, batch)
            aa, g, Gb = G[0, 0], G[1:, 0], G[1:, 1:]
        with span("gpar.bound"):
            # float64 factor with the working precision's relative jitter, as
            # the JAX package applies to its float32 K_uu.
            L_uu = cholesky_psd(Kuu.double(), default_jitter(Kuu.dtype))
    return DTCIntermediates(aa=aa, g=g, Gb=Gb, L_uu=L_uu, logdet_noise=logdet_noise)


def _scan_gram(filter_fn, lgssm: LGSSM, batch):
    """(G, logdet) in float64 of the M + 1 columns through a scan engine:
    ``"blocked"`` and ``"pallas"`` by their closed-form gradients, a filter
    callable (None: the sequential filter) by autograd.  ``"pallas"`` sends
    the SDEs the kernels cannot take to the associative-scan filter, as the
    JAX package does."""
    if filter_fn == "blocked":
        from gpar_at_scale_torch.ssm.blocked_grad import whiten_gram

        return whiten_gram(lgssm, batch)
    if filter_fn == "pallas":
        from gpar_at_scale_torch.ops.kalman import pallas_supported

        if pallas_supported(lgssm):
            from gpar_at_scale_torch.ops.whiten import whiten_gram

            return whiten_gram(lgssm, batch)
        from gpar_at_scale_torch.ssm.pkalman import parallel_filter

        filter_fn = parallel_filter
    gram = getattr(filter_fn, "gram", None)
    if gram is not None:  # an engine with its own Gram (parallel/seqshard.py)
        return gram(lgssm, batch)
    res = (filter_fn or kalman_filter)(lgssm, batch)
    W = (res.v / torch.sqrt(res.S)[:, None]).double()
    return W.T @ W, torch.log(res.S).double().sum()


def _lam_chol(inter: DTCIntermediates):
    """chol(A A^T + I) with A A^T = L_uu^-1 Gb L_uu^-T from the Gram form."""
    AAt = solve_lower(inter.L_uu, solve_lower(inter.L_uu, inter.Gb).T)
    Lam = AAt + torch.eye(AAt.shape[0], dtype=AAt.dtype, device=AAt.device)
    L = torch.linalg.cholesky(0.5 * (Lam + Lam.T))
    host_sync()  # the factorization's info check
    return L


def dtc_objective(
    out_kernel: Kernel,
    time_lgssm: LGSSM,
    V,
    Z,
    y,
    mean=0.0,
    uu_ridge="auto",
    filter_fn=None,
    *,
    time_kernel=None,
    t=None,
):
    """The DTC evidence bound in the P-form of the JAX package:
    with P = Gb + K_uu, log det Lam = log det P - log det K_uu and
    |chol(Lam)^-1 L_uu^-1 g|^2 = g^T P^-1 g."""
    inter = _whiten_all(
        out_kernel, V, Z, time_lgssm, y, mean, uu_ridge, filter_fn,
        time_kernel=time_kernel, t=t,
    )
    return dtc_bound(inter, y.shape[0])


def dtc_bound(inter: DTCIntermediates, n: int):
    """The P-form DTC bound of n observations from its Gram intermediates."""
    with span("gpar.bound"):
        Kuu_r = inter.L_uu @ inter.L_uu.T
        L_P = torch.linalg.cholesky(inter.Gb + Kuu_r)
        host_sync()  # the factorization's info check
        wp = solve_lower(L_P, inter.g)
        logdet_lam = logdet_from_chol(L_P) - logdet_from_chol(inter.L_uu)
        quad = inter.aa - (wp * wp).sum()
        return -0.5 * (n * _LOG_2PI + inter.logdet_noise + logdet_lam + quad)


class QU(NamedTuple):
    """Whitened pseudo-point posterior q(eps) = N(m_eps, D^-1); the latent
    loads as f_x(.) = K_.u L_uu^-T eps."""

    m_eps: torch.Tensor  # (M,)
    L_D: torch.Tensor  # (M, M) chol(D), D = A A^T + I
    L_uu: torch.Tensor  # (M, M) chol(K_uu)
    Z: torch.Tensor  # (M, D) inducing inputs

    def sample_eps(self, generator: torch.Generator, num_samples: int):
        """(M, num_samples) draws eps ~ N(m_eps, D^-1): m_eps + L_D^-T xi,
        with xi standard normal from ``generator`` (drawn on its device)."""
        xi = torch.randn((self.m_eps.shape[0], num_samples), generator=generator,
                         dtype=self.m_eps.dtype, device=generator.device)
        return self.m_eps[:, None] + solve_upper(self.L_D, xi.to(self.m_eps.device))


def compute_q_u(
    out_kernel: Kernel,
    time_lgssm: LGSSM,
    V,
    Z,
    y,
    mean=0.0,
    uu_ridge="auto",
    filter_fn=None,
    *,
    time_kernel=None,
    t=None,
) -> QU:
    """Closed-form whitened posterior over the inducing points, prior mean
    subtracted.  On the kernel path its factors are float64."""
    inter = _whiten_all(
        out_kernel, V, Z, time_lgssm, y, mean, uu_ridge, filter_fn,
        time_kernel=time_kernel, t=t,
    )
    L_D = _lam_chol(inter)
    m_eps = cho_solve(L_D, solve_lower(inter.L_uu, inter.g))
    return QU(m_eps=m_eps, L_D=L_D, L_uu=inter.L_uu, Z=_as_2d(Z))


class _DenseSmooth(NamedTuple):
    mean: torch.Tensor  # (..., N, B) posterior means of f_t per column
    var: torch.Tensor  # (..., N)   posterior marginal variances


def _dense_condition(K, noise_s, cols, prior_var):
    """Dense GP conditioning of the columns ``cols`` (..., N, B) on the
    prior covariance K (..., N, N) with the observation noise ``noise_s``:
    E[f] = K (K + diag(noise))^-1 cols, Var[f] = prior_var - diag(K (K + D)^-1 K).
    A leading batch axis rides through every step; under the dense switch
    the whole batch is one K6a launch with N + B columns."""
    n_all = K.shape[-1]
    Sigma = K + torch.diag_embed(noise_s.expand(K.shape[:-1]))
    both = torch.cat([K, cols], dim=-1)
    if _pallas_dense_ok(Sigma, both):
        _, Wb, _ = chol_solve(Sigma, both)  # one K6a launch, N_all + M + 1 columns
    else:
        L = torch.linalg.cholesky(Sigma)
        host_sync()  # the factorization's info check
        Wb = solve_lower(L, both)
    W = Wb[..., :n_all]  # L^-1 K: W^T W = K Sigma^-1 K
    mean = W.transpose(-1, -2) @ Wb[..., n_all:]
    var = prior_var - (W * W).sum(-2)
    return _DenseSmooth(mean=mean, var=torch.clamp(var, min=0.0))


def _dense_smoother(time_kernel: Kernel, t_s, noise_s):
    """Dense equivalent of the RTS smoother over the spliced series:
    E[f] = K (K + diag(noise))^-1 y, Var[f] = diag(K - K (K + D)^-1 K)."""

    def smooth(lgssm, cols):
        del lgssm  # the same temporal posterior, computed densely
        t2 = t_s[:, None]
        return _dense_condition(time_kernel(t2, t2), noise_s, cols, time_kernel.diag_part(t2))

    return smooth


def smoother_for(time_kernel: Kernel, t_s, noise_s):
    """The smoother ``(lgssm, cols) -> SmoothResult`` of a spliced series:
    dense GP conditioning when it has N_all <= DENSE_N_MAX steps, else the
    blocked smoother (``ssm/blocked.py``)."""
    if t_s.shape[0] <= DENSE_N_MAX:
        return _dense_smoother(time_kernel, t_s, noise_s)
    from gpar_at_scale_torch.ssm.blocked import blocked_smooth

    return blocked_smooth


def splice(t, t_star, noise_var, dtype):
    """Sort train and test times together; test points get the 1e10
    observation noise of the reference's splice.  Returns (order, inverse
    order, sorted times, sorted noise); the sort is stable, so a test time
    equal to a training time lands after it, as in the JAX package."""
    n, n_star = t.shape[0], t_star.shape[0]
    t_all = torch.cat([t.to(dtype), t_star.to(dtype)])
    if not (torch.is_tensor(noise_var) and noise_var.device == t.device):
        host_sync()  # the noise is copied from the host
    noise_all = torch.cat([
        torch.as_tensor(noise_var, dtype=dtype, device=t.device).expand(n),
        torch.full((n_star,), 1e10, dtype=dtype, device=t.device),
    ])
    order = torch.argsort(t_all, stable=True)
    inv_order = torch.argsort(order, stable=True)
    return order, inv_order, t_all[order], noise_all[order]


def _tri_inverse(L):
    """L^-1 of a lower-triangular M x M factor, in float64."""
    L = L.double()
    return solve_lower(L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device))


class ScaledPrediction(NamedTuple):
    mean: torch.Tensor  # (N*,)
    var: torch.Tensor  # (N*,) latent-function variance (no obs noise)


def predict_scaled(
    out_kernel: Kernel,
    time_kernel: Kernel,
    qu: QU,
    V,
    t,
    y,
    t_star,
    V_star,
    noise_var,
    mean=0.0,
    *,
    num_samples: int = 0,
    generator: torch.Generator = None,
    dtype=torch.float64,
) -> ScaledPrediction:
    """Posterior predictive of f* = f_x* + f_t* at (t_star, V_star): splice
    the test times into the series with infinite observation noise, subtract
    f_x, smooth the rest with the temporal LGSSM, add f_x back.

    With ``num_samples == 0`` the predictive is exact, since the smoother is
    linear in its observations:

        E[f*]   = fx_bar + S (y - fx_bar)
        Var[f*] = rowsum(((I - S) G)^2) + diag(P_smooth)

    with fx_bar = K_*u L^-T m_eps and G = K_*u L^-T L_D^-T.  With
    ``num_samples = S > 0`` it is the reference's Monte-Carlo estimate: S
    draws eps ~ q(eps) from ``generator`` (``QU.sample_eps``; without one it
    raises ``ValueError``), f_x = K_*u L^-T eps, one smoothing pass over the
    S columns y - f_x, and the mean and variance of f_x + the smoothed mean
    over the draws, plus the smoother's own variance diag(P_smooth) (the JAX
    package's repair of the reference's variance).

    The q(u) factors are cast to ``dtype``.  Up to DENSE_N_MAX spliced
    steps, K_*u L^-T and Phi L_D^-T are two triangular solves in ``dtype``,
    as in the JAX package (K6b under the dense switch); above it they are
    products with float64 inverse factors, since a triangular solve with
    N_all ~ 1e6 right-hand sides takes seconds on the card.  The call is
    the span ``gpar.predict``, its smoother ``gpar.predict.smooth``."""
    eps = None
    if num_samples > 0:
        if generator is None:
            raise ValueError("num_samples > 0 requires a torch.Generator")
        eps = qu.sample_eps(generator, num_samples)
    with span("gpar.predict"):
        return _predict_scaled(out_kernel, time_kernel, qu, V, t, y, t_star, V_star, noise_var,
                               mean, eps=eps, dtype=dtype)


def _predict_scaled(
    out_kernel, time_kernel, qu: QU, V, t, y, t_star, V_star, noise_var, mean=0.0, *,
    eps=None, dtype=torch.float64,
) -> ScaledPrediction:
    """``predict_scaled``'s body: analytic with ``eps=None``, else the
    Monte-Carlo estimate over the given (M, S) draws of eps."""
    V, V_star = _as_2d(V).to(dtype), _as_2d(V_star).to(dtype)
    t, t_star, y = t.to(dtype), t_star.to(dtype), y.to(dtype)
    n = t.shape[0]
    order, inv_order, t_s, noise_s = splice(t, t_star, noise_var, dtype)
    V_s = torch.cat([V, V_star])[order]
    y_s = torch.cat([y - mean, y.new_zeros(t_star.shape[0])])[order]

    smooth_fn = smoother_for(time_kernel, t_s, noise_s)
    lgssm = lgssm_of(time_kernel, t_s, noise_s, dtype)

    K_su = out_kernel(V_s, qu.Z.to(dtype))  # (N_all, M)
    dense = t_s.shape[0] <= DENSE_N_MAX
    if dense:
        Phi = solve_lower(qu.L_uu.to(dtype), K_su.T).T  # K_*u L_uu^-T
    else:
        # products with the inverse factors, inverted in float64 on the
        # M x M side (milliseconds where the solves take seconds)
        Phi = K_su @ _tri_inverse(qu.L_uu).to(dtype).T
    if eps is None:
        if dense:
            G = solve_lower(qu.L_D.to(dtype), Phi.T).T  # Phi L_D^-T; Cov[f_x] = G G^T
        else:
            G = Phi @ _tri_inverse(qu.L_D).to(dtype).T
        fx_bar = Phi @ qu.m_eps.to(dtype)
        with span("gpar.predict.smooth"):
            sm = smooth_fn(lgssm, torch.cat([(y_s - fx_bar)[:, None], G], dim=1))
        mean_all = fx_bar + sm.mean[:, 0]
        H = G - sm.mean[:, 1:]  # (I - S) G
        var_all = (H * H).sum(1) + sm.var
    else:
        fx = Phi @ eps.to(dtype)  # (N_all, S)
        with span("gpar.predict.smooth"):
            sm = smooth_fn(lgssm, y_s[:, None] - fx)
        f = fx + sm.mean
        mean_all = f.mean(1)
        var_all = f.var(1, correction=0) + sm.var
    mean_star = (mean + mean_all)[inv_order][n:]
    var_star = var_all[inv_order][n:]
    return ScaledPrediction(mean=mean_star, var=torch.clamp(var_star, min=0.0))


def _batched_kernel(kernel: Kernel, dtype, device):
    """A stationary kernel whose hyperparameters are (B,) tensors, with
    them as (B, 1, 1): its Gram of (N, D) inputs is then (B, N, N)
    (``kernels/base.py::sq_dist`` broadcasts the scaled inputs)."""
    from gpar_at_scale_torch.kernels.stationary import StationaryKernel

    if not isinstance(kernel, StationaryKernel):
        raise TypeError(f"the batched predictive takes stationary kernels, got {type(kernel).__name__}")
    out = copy.copy(kernel)
    for name in ("lengthscale", "variance"):
        v = torch.as_tensor(getattr(kernel, name), dtype=dtype, device=device)
        if v.ndim != 1:
            raise ValueError(f"the batched predictive takes (B,) hyperparameters, "
                             f"got {name} of shape {tuple(v.shape)}")
        setattr(out, name, v[:, None, None])
    return out


def predict_scaled_batch(
    out_kernel, time_kernel, qu: QU, V, t, y, t_star, V_star, noise_var, mean=0.0, *,
    dtype=torch.float64,
) -> ScaledPrediction:
    """``predict_scaled`` (analytic) for B hyperparameter sets against one
    cached q(u): the lengthscales and variances of both stationary kernels
    and ``noise_var`` are (B,) tensors.  Returns means and variances
    (B, N*), each row the ``predict_scaled`` of its parameter set.  This is
    the JAX package's ``jax.vmap`` of ``predict_scaled`` over parameter
    vectors (``bench.py``'s batched serving).

    Up to DENSE_N_MAX spliced steps (N + N*) q(u)'s factors are shared,
    so K_*u L_uu^-T and Phi L_D^-T are one triangular solve each over all
    B x N_all rows (K6b under the dense switch), and the smoother factors
    the B spliced covariances and solves their N_all + M + 1 columns in
    one K6a launch (under "off", batched ``torch.linalg``).

    Above it (the scan branch) Phi and G are products with q(u)'s float64
    inverse factors, as in ``predict_scaled``; the B spliced LGSSMs are
    discretized at once (``ssm/markov.py::lgssm_batch_of``) and laid end to
    end as one series of B N_all steps, whose M + 1 columns [y - fx_bar | G]
    go through the kernels once (``ops/smoother.py::smooth_columns``: K1/K2,
    K3, K7, K4a/K4b), so launches and host syncs do not grow with B; only the
    held-out rows are kept.  Batches of more than ``SCAN_BATCH_STEPS``
    steps run in chunks of draws.  float32 requests take the kernels,
    float64 ones the tensor-code blocked smoother.

    The call is the span ``gpar.request``, its stages
    ``gpar.request.splice``, ``.kernels``, ``.shared_solves``, then
    ``.condition`` (dense) or ``.discretize`` and ``.smooth`` (scan), and
    ``.moments``."""
    with span("gpar.request"):
        return _predict_scaled_batch(out_kernel, time_kernel, qu, V, t, y, t_star, V_star,
                                     noise_var, mean, dtype)


def _predict_scaled_batch(out_kernel, time_kernel, qu: QU, V, t, y, t_star, V_star, noise_var,
                          mean, dtype) -> ScaledPrediction:
    V, V_star = _as_2d(V).to(dtype), _as_2d(V_star).to(dtype)
    t, t_star, y = t.to(dtype), t_star.to(dtype), y.to(dtype)
    n, n_star = t.shape[0], t_star.shape[0]
    n_all = n + n_star
    if n_all > DENSE_N_MAX:
        return _predict_batch_scan(out_kernel, time_kernel, qu, V, t, y, t_star, V_star,
                                   noise_var, mean, dtype)
    dev = t.device
    out_b, time_b = _batched_kernel(out_kernel, dtype, dev), _batched_kernel(time_kernel, dtype, dev)
    nv = torch.as_tensor(noise_var, dtype=dtype, device=dev)
    b = nv.shape[0]
    with span("gpar.request.splice"):
        order, inv_order, t_s, _ = splice(t, t_star, 0.0, dtype)
        noise_s = torch.cat([nv[:, None].expand(b, n),
                             torch.full((b, n_star), 1e10, dtype=dtype, device=dev)], dim=1)[:, order]
        V_s = torch.cat([V, V_star])[order]
        y_s = torch.cat([y - mean, y.new_zeros(n_star)])[order]

    def solve_shared(L, X):  # L^-1 X^T for X (b, N_all, M): one solve, b N_all columns
        m = X.shape[-1]
        out = solve_lower(L.to(dtype), X.permute(2, 0, 1).reshape(m, -1))
        return out.reshape(m, b, n_all).permute(1, 2, 0)

    with span("gpar.request.kernels"):
        K_su = out_b(V_s, qu.Z.to(dtype))  # (b, N_all, M)
        t2 = t_s[:, None]
        K_tt = time_b(t2, t2)  # (b, N_all, N_all)
    with span("gpar.request.shared_solves"):
        Phi = solve_shared(qu.L_uu, K_su)  # K_*u L_uu^-T
        G = solve_shared(qu.L_D, Phi)  # Phi L_D^-T
        fx_bar = Phi @ qu.m_eps.to(dtype)  # (b, N_all)
    with span("gpar.request.condition"):
        sm = _dense_condition(K_tt, noise_s, torch.cat([(y_s - fx_bar)[..., None], G], dim=-1),
                              time_b.variance[:, :, 0].expand(b, n_all))
    with span("gpar.request.moments"):
        mean_all = fx_bar + sm.mean[..., 0]
        H = G - sm.mean[..., 1:]
        var_all = (H * H).sum(-1) + sm.var
        mean_star = (mean + mean_all)[:, inv_order][:, n:]
        return ScaledPrediction(mean=mean_star,
                                var=torch.clamp(var_all[:, inv_order][:, n:], min=0.0))


# Most steps (draws x spliced steps) one pass of the scan branch of
# ``predict_scaled_batch`` takes: about 1 KiB of device memory a step with
# M = 32 (the filtered means and the smoothed columns, (3, M + 1) float32
# each), so 64 draws at N_all = 1.01e6 run as one pass on an 80 GB card.
SCAN_BATCH_STEPS = 1 << 26


def _draws(kernel: Kernel, sl: slice):
    """``kernel`` with the draws ``sl`` of its (B,) hyperparameters."""
    out = copy.copy(kernel)
    for name in ("lengthscale", "variance"):
        setattr(out, name, getattr(kernel, name)[sl])
    return out


def _predict_batch_scan(out_kernel, time_kernel, qu: QU, V, t, y, t_star, V_star, noise_var,
                        mean, dtype) -> ScaledPrediction:
    """The scan branch of ``predict_scaled_batch`` (inputs already in
    ``dtype``)."""
    from gpar_at_scale_torch.ops.smoother import smooth_columns
    from gpar_at_scale_torch.ssm.markov import lgssm_batch_of

    dev = t.device
    n, n_star = t.shape[0], t_star.shape[0]
    n_all = n + n_star
    as_b = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)  # noqa: E731
    out_k, time_k = copy.copy(out_kernel), copy.copy(time_kernel)
    for k in (out_k, time_k):
        k.lengthscale, k.variance = as_b(k.lengthscale), as_b(k.variance)
    nv = as_b(noise_var)
    b = nv.shape[0]
    with span("gpar.request.splice"):
        order, inv_order, t_s, _ = splice(t, t_star, 0.0, dtype)
        V_s = torch.cat([V, V_star])[order]
        y_s = torch.cat([y - mean, y.new_zeros(n_star)])[order]
        held = inv_order[n:]  # the held-out rows of the spliced series, in t_star's order
    with span("gpar.request.shared_solves"):
        W_uu = _tri_inverse(qu.L_uu).to(dtype).T  # Phi = K_*u W_uu
        W_D = _tri_inverse(qu.L_D).to(dtype).T  # G = Phi W_D
        m_eps = qu.m_eps.to(dtype)
    step = max(1, SCAN_BATCH_STEPS // n_all)
    means, variances = [], []
    for lo in range(0, b, step):
        sl = slice(lo, min(b, lo + step))
        c = sl.stop - sl.start
        with span("gpar.request.discretize"):
            noise = torch.cat([nv[sl, None].expand(c, n),
                               torch.full((c, n_star), 1e10, dtype=dtype, device=dev)], dim=1)
            lg = lgssm_batch_of(_draws(time_k, sl), t_s, noise[:, order], dtype)
            del noise
        with span("gpar.request.kernels"):
            K_su = _batched_kernel(_draws(out_k, sl), dtype, dev)(V_s, qu.Z.to(dtype))  # (c, N_all, M)
        with span("gpar.request.shared_solves"):
            Phi = K_su @ W_uu
            del K_su
            G = Phi @ W_D
            fx_bar = Phi @ m_eps  # (c, N_all)
            del Phi
            resid = y_s - fx_bar
            fx_held, G_held = fx_bar[:, held], G[:, held]
            del fx_bar
        with span("gpar.request.smooth"):
            # one series of c N_all steps; handed over without a reference
            # kept here, so that the smoother drops the columns once read
            cols = [torch.cat([resid[..., None], G], dim=-1).reshape(c * n_all, -1)]
            del G, resid
            sm_mean, sm_var = smooth_columns(lg, cols.pop())
            del lg
            rows = (torch.arange(c, device=dev) * n_all)[:, None] + held[None, :]
            s_mean, s_var = sm_mean[rows].to(dtype), sm_var[rows].to(dtype)  # (c, N*, M + 1), (c, N*)
            del sm_mean, sm_var
        with span("gpar.request.moments"):
            means.append(mean + fx_held + s_mean[..., 0])
            H = G_held - s_mean[..., 1:]  # (I - S) G at the held-out rows
            variances.append(torch.clamp((H * H).sum(-1) + s_var, min=0.0))
    return ScaledPrediction(mean=torch.cat(means), var=torch.cat(variances))


# ---------------------------------------------------------------------------
# The iid-noise sparse GP (no temporal structure): the DTC bound, the Titsias
# ELBO and the projected-process predictive
# ---------------------------------------------------------------------------


def dtc_objective_iid(kernel: Kernel, V, Z, y, noise_var, mean=0.0):
    """Collapsed DTC bound with iid noise s2 I: log N(y | m, Q_ff + s2 I),
    Q_ff = K_fu K_uu^-1 K_uf, through the M x M system (O(N M^2))."""
    V, Z = _as_2d(V), _as_2d(Z)
    n = y.shape[0]
    s2 = torch.as_tensor(noise_var, dtype=y.dtype, device=y.device)
    L_uu = cholesky_psd(kernel(Z, Z))
    A = solve_lower(L_uu, kernel(V, Z).T) / torch.sqrt(s2)  # (M, N)
    Lam = A @ A.T + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    L_lam = torch.linalg.cholesky(Lam)
    r = (y - mean) / torch.sqrt(s2)
    w = solve_lower(L_lam, A @ r)
    logdet = n * torch.log(s2) + logdet_from_chol(L_lam)
    quad = (r * r).sum() - (w * w).sum()
    return -0.5 * (n * _LOG_2PI + logdet + quad)


def titsias_elbo(kernel: Kernel, V, Z, y, noise_var, mean=0.0):
    """Titsias (2009) collapsed variational bound: the DTC bound minus
    trace(K_ff - Q_ff) / (2 s2)."""
    V, Z = _as_2d(V), _as_2d(Z)
    U = solve_lower(cholesky_psd(kernel(Z, Z)), kernel(V, Z).T)  # (M, N)
    trace_term = (kernel.diag_part(V) - (U * U).sum(0)).sum() / (2.0 * noise_var)
    return dtc_objective_iid(kernel, V, Z, y, noise_var, mean) - trace_term


def predict_sparse_iid(kernel: Kernel, V, Z, y, noise_var, V_star, mean=0.0):
    """Projected-process predictive with iid noise: (mean, latent variance)
    at V_star, mean = m + K_*u L^-T m_eps and
    var = k_** - |K_*u L^-T|^2 + |K_*u L^-T L_D^-T|^2."""
    V, Z, V_star = _as_2d(V), _as_2d(Z), _as_2d(V_star)
    s2 = torch.as_tensor(noise_var, dtype=y.dtype, device=y.device)
    L_uu = cholesky_psd(kernel(Z, Z))
    A = solve_lower(L_uu, kernel(V, Z).T) / torch.sqrt(s2)  # (M, N)
    D = A @ A.T + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    L_D = torch.linalg.cholesky(D)
    m_eps = solve_upper(L_D, solve_lower(L_D, A @ ((y - mean) / torch.sqrt(s2))))
    Phi = solve_lower(L_uu, kernel(V_star, Z).T).T  # K_*u L_uu^-T
    G = solve_lower(L_D, Phi.T).T
    var = kernel.diag_part(V_star) - (Phi * Phi).sum(1) + (G * G).sum(1)
    return mean + Phi @ m_eps, torch.clamp(var, min=0.0)
