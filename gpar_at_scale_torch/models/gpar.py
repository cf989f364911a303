"""GPAR -- Gaussian Process Autoregressive Regression, the model chain.

Counterpart of ``gpar_at_scale_tpu/models/gpar.py``.  Output 1 is a GP on
time: ``temporal`` (the LGSSM's Kalman likelihood, O(N)) or ``exact``
(``gp/exact.py``, dense).  Every later output i is a conditional over
(t, y_1..y_{i-1}): ``scaled`` (DTC pseudo-points over the previous outputs
with the temporal LGSSM as structured noise, ``gp/dtc.py``) or ``exact``
(the dense GP with the additive GPAR kernel).  Prediction feeds the
predicted means down the chain.

``fit_*`` train the log-hyperparameters by type-II maximum likelihood
(``inference/optimize.py``: L-BFGS or Adam on the exact gradient, through
the closed-form disturbance-smoother VJPs on the kernel path) and then
condition: output 1 keeps its data, each conditional computes q(u) at the
optimum.  With ``max_opt_steps = 0`` they condition on the parameters they
are given and evaluate no objective.  ``fit_gpar(parallel=True)``, the JAX
package's vmapped fit of the conditionals, gives the same fits here
(``fit_conditionals_parallel``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

from gpar_at_scale_torch.device import resolve_device
from gpar_at_scale_torch.gp import exact as exact_gp
from gpar_at_scale_torch.gp.dtc import (
    DENSE_N_MAX,
    QU,
    compute_q_u,
    dtc_objective,
    predict_scaled,
    smoother_for,
    splice,
)
from gpar_at_scale_torch.inference.optimize import OptResult, minimize_adam, minimize_lbfgs
from gpar_at_scale_torch.kernels import Matern52, gpar_kernel, time_kernel_only
from gpar_at_scale_torch.ssm.kalman import kalman_filter
from gpar_at_scale_torch.ssm.kalman import logpdf as ssm_logpdf
from gpar_at_scale_torch.ssm.markov import lgssm_of
from gpar_at_scale_torch.ssm.pkalman import parallel_filter, parallel_logpdf
from gpar_at_scale_torch.utils.observability import host_sync, span
from gpar_at_scale_torch.utils.params import init_params, unpack_gp, unpack_gpar, unpack_gpar6


@dataclass(frozen=True)
class GPARConfig:
    """Per-model configuration, the JAX package's fields.

    backend: 'exact' (dense GP, ``gp/exact.py``) or 'scaled' (DTC) for the
    conditionals; first_output_backend: 'temporal' or 'exact' for output 1.
    The dense factorizations of 'exact' and of the scaled backend's dense
    branch take the kernels K6a-c when ``engine.pallas_dense`` is switched
    on (``config.py``, ``utils/psd.py``).

    filter_impl: whitening engine of the scaled conditionals and filter of
    output 1's likelihood --
      'auto'       conditionals: dense chol(Sigma_y) when N <= gp.dtc.
                   DENSE_N_MAX, the CUDA kernels above; output 1: the
                   sequential filter when N <= DENSE_N_MAX, the kernels
                   above;
      'dense'      conditionals: the dense backend; output 1: sequential;
      'sequential' the sequential Kalman filter (numerical oracle);
      'associative' the associative-scan filter (ssm/pkalman.py), any
                   state dim, autograd; output 1: the same engine;
      'blocked'    the tensor-code blocked filter with the closed-form
                   gradient (ssm/blocked_grad.py), any state dim;
      'pallas'     the CUDA blocked-scan kernels K1-K3 forward and K4a/K4b
                   backward (the JAX package's name for its TPU kernels);
                   sum-kernel SDEs take the associative engine instead.
    optimizer: 'lbfgs' | 'adam'.
    """

    time_family: Any = Matern52
    out_family: Any = Matern52
    backend: str = "exact"  # 'exact' | 'scaled'
    first_output_backend: str = "temporal"  # 'exact' | 'temporal'
    num_pseudo_points: int = 50
    max_opt_steps: int = 200
    optimizer: str = "lbfgs"  # 'lbfgs' | 'adam'
    dtype: Any = torch.float64
    filter_impl: str = "auto"
    separate_noise: bool = False


def _minimize(cfg: GPARConfig, fun, x0) -> OptResult:
    if cfg.optimizer == "adam":
        return minimize_adam(fun, x0, max_steps=cfg.max_opt_steps)
    return minimize_lbfgs(fun, x0, max_steps=cfg.max_opt_steps)


def _train(cfg: GPARConfig, nll, x0):
    """(params, OptResult or None): no objective is evaluated when
    ``max_opt_steps`` is 0 (the JAX package's L-BFGS evaluates one gradient
    at x0 even then)."""
    if cfg.max_opt_steps == 0:
        return x0, None
    res = _minimize(cfg, nll, x0)
    return res.params, res


def _unpack_cond(cfg: GPARConfig, p):
    """(time_l, time_sigma, out_l, out_sigma, noise_sigma, time_noise_sigma);
    the 5-parameter pack aliases the temporal noise to the output noise."""
    if cfg.separate_noise:
        return unpack_gpar6(p)
    tl, ts, ol, osig, ns = unpack_gpar(p)
    return tl, ts, ol, osig, ns, ns


def _filter_fn_of(cfg: GPARConfig):
    """GPARConfig.filter_impl -> gp.dtc's filter_fn argument."""
    table = {
        "auto": None, "dense": "dense", "sequential": kalman_filter,
        "associative": parallel_filter, "blocked": "blocked", "pallas": "pallas",
    }
    if cfg.filter_impl not in table:
        raise ValueError(f"unknown filter_impl {cfg.filter_impl!r}")
    return table[cfg.filter_impl]


def _as(x, cfg: GPARConfig, device):
    return torch.as_tensor(x).to(device=device, dtype=cfg.dtype)


def _params(init, n: int, generator, cfg: GPARConfig, device):
    if init is None:
        return init_params(n, generator, cfg.dtype, device)
    p = _as(init, cfg, device)
    if p.shape != (n,):
        raise ValueError(f"expected {n} log-parameters, got shape {tuple(p.shape)}")
    return p


# ---------------------------------------------------------------------------
# Single-conditional fits
# ---------------------------------------------------------------------------


@dataclass
class FittedGP:
    """First output of the chain: a GP on time (``temporal`` or ``exact``)."""

    params: torch.Tensor  # (3,) log-params
    cfg: GPARConfig
    t: torch.Tensor
    y: torch.Tensor
    backend: str
    opt: Optional[OptResult] = None  # the optimizer's result, if it ran

    def hyperparams(self) -> Tuple:
        return tuple(float(v) for v in unpack_gp(self.params))

    def predict(self, t_star):
        l, ps, ns = unpack_gp(self.params)
        k = time_kernel_only(self.cfg.time_family, l, ps)
        t_star = _as(t_star, self.cfg, self.t.device)
        if self.backend == "exact":
            post = exact_gp.condition(k, self.t[:, None], self.y, ns**2)
            return post.predict_f(t_star[:, None])
        return _temporal_predict(k, self.t, self.y, t_star, ns**2, self.cfg.dtype)


def _temporal_predict(kernel, t, y, t_star, noise_var, dtype):
    """Splice the test times in with infinite noise and smooth.  The JAX
    package runs the sequential RTS smoother here; the port dispatches as
    ``predict_scaled`` does: dense conditioning at N_all <= DENSE_N_MAX, the
    blocked smoother above."""
    n = t.shape[0]
    order, inv, t_s, noise_s = splice(t, t_star, noise_var, dtype)
    y_s = torch.cat([y.to(dtype), y.new_zeros(t_star.shape[0], dtype=dtype)])[order]
    smooth = smoother_for(kernel, t_s, noise_s)
    sm = smooth(lgssm_of(kernel, t_s, noise_s, dtype), y_s[:, None])
    return sm.mean[:, 0][inv][n:], sm.var[inv][n:]


def _first_output_nll(cfg: GPARConfig, t, y):
    """Output 1's negative log-likelihood in its log-parameters.  'auto'
    takes the sequential filter only up to DENSE_N_MAX steps, where the JAX
    package takes it at every N: the port's sequential filter is a Python
    loop of N steps, so longer series go through the kernels.  For the same
    reason 'associative' takes the associative-scan filter here, where the
    JAX package takes the sequential one: both compute the same function."""
    impl = cfg.filter_impl
    if impl == "auto":
        impl = "sequential" if t.shape[0] <= DENSE_N_MAX else "pallas"
    if impl == "pallas":
        from gpar_at_scale_torch.ops.grad import logpdf_markov_pallas

        def ll(k, nv):
            return logpdf_markov_pallas(k, t, nv, y)
    elif impl == "blocked":
        from gpar_at_scale_torch.ssm.blocked_grad import blocked_loglik

        def ll(k, nv):
            return blocked_loglik(lgssm_of(k, t, nv, cfg.dtype), y)
    elif impl == "associative":

        def ll(k, nv):
            return parallel_logpdf(lgssm_of(k, t, nv, cfg.dtype), y)
    elif impl in ("sequential", "dense"):

        def ll(k, nv):
            return ssm_logpdf(lgssm_of(k, t, nv, cfg.dtype), y)
    else:
        raise ValueError(f"unknown filter_impl {impl!r}")

    def nll(p):
        l, ps, ns = unpack_gp(p)
        return -ll(time_kernel_only(cfg.time_family, l, ps), ns**2)

    return nll


def _exact_first_output_nll(cfg: GPARConfig, t, y):
    def nll(p):
        l, ps, ns = unpack_gp(p)
        return exact_gp.nlml(time_kernel_only(cfg.time_family, l, ps), t[:, None], y, ns**2)

    return nll


def fit_first_output(generator, t, y, cfg: GPARConfig, init_params=None, *, device=None) -> FittedGP:
    """Type-II ML for the GP of output 1 on time: its likelihood by the
    Kalman filter (O(N); the data are stored sorted by time) or, with
    ``first_output_backend="exact"``, the dense exact GP (the data as
    given, as in the JAX package)."""
    backend = cfg.first_output_backend
    if backend not in ("temporal", "exact"):
        raise ValueError(f"unknown first_output_backend {backend!r}")
    device = resolve_device(device)
    t, y = _as(t, cfg, device), _as(y, cfg, device)
    x0 = _params(init_params, 3, generator, cfg, device)
    if backend == "exact":
        params, res = _train(cfg, _exact_first_output_nll(cfg, t, y), x0)
        return FittedGP(params=params, cfg=cfg, t=t, y=y, backend="exact", opt=res)
    order = torch.argsort(t, stable=True)
    t_s, y_s = t[order], y[order]
    params, res = _train(cfg, _first_output_nll(cfg, t_s, y_s), x0)
    return FittedGP(params=params, cfg=cfg, t=t_s, y=y_s, backend="temporal", opt=res)


@dataclass
class FittedConditional:
    """Conditional GP for output i >= 2 over inputs (t, y_1..y_{i-1})."""

    params: torch.Tensor  # (5,) or (6,) log-params
    cfg: GPARConfig
    t: torch.Tensor  # (N,)
    X_prev: torch.Tensor  # (N, i-1) previous-output features
    y: torch.Tensor  # (N,)
    backend: str
    Z: Optional[torch.Tensor] = None  # (M, i-1) inducing inputs
    qu: Optional[QU] = None
    opt: Optional[OptResult] = None  # the optimizer's result, if it ran

    def hyperparams(self) -> Tuple:
        unpack = unpack_gpar6 if self.cfg.separate_noise else unpack_gpar
        return tuple(float(v) for v in unpack(self.params))

    def _kernels(self):
        tl, ts, ol, osig, ns, tns = _unpack_cond(self.cfg, self.params)
        time_k = time_kernel_only(self.cfg.time_family, tl, ts)
        out_k = self.cfg.out_family(lengthscale=ol, variance=osig**2)
        # The predictive smooths y - f_x = f_t + eps: its noise is the
        # temporal one.
        return time_k, out_k, tns**2

    def predict(self, t_star, X_prev_star):
        t_star = _as(t_star, self.cfg, self.t.device)
        X_prev_star = _as(X_prev_star, self.cfg, self.t.device)
        if self.backend == "exact":
            k, nv = _exact_kernel(self.cfg, 1 + self.X_prev.shape[1], self.params)
            post = exact_gp.condition(k, _features(self.t, self.X_prev), self.y, nv)
            return post.predict_f(_features(t_star, X_prev_star))
        time_k, out_k, nv = self._kernels()
        pred = predict_scaled(
            out_k, time_k, self.qu, self.X_prev, self.t, self.y, t_star, X_prev_star,
            nv, dtype=self.cfg.dtype,
        )
        return pred.mean, pred.var


def _features(t, X_prev):
    """(N, 1 + i - 1) inputs of the exact conditional: time, then the
    previous outputs."""
    return torch.cat([t[:, None], X_prev], dim=1)


def _exact_kernel(cfg: GPARConfig, input_dim: int, p):
    tl, ts, ol, osig, ns = unpack_gpar(p)
    return gpar_kernel(cfg.time_family, cfg.out_family, input_dim, tl, ts, ol, osig), ns**2


def _select_pseudo_points(X, m: int):
    """Evenly strided subset of the inputs as inducing points (the JAX
    package's linspace-and-truncate indices)."""
    n = X.shape[0]
    if m >= n:
        return X
    idx = torch.linspace(0, n - 1, m, dtype=torch.float64).to(torch.int64)
    host_sync()  # the indices are copied from the host
    return X[idx.to(X.device)]


def _conditional_bound(cfg: GPARConfig, t_s, X_s, y_s, Z):
    """``at(fn, p)``: the DTC quantity ``fn`` (``dtc_objective`` or
    ``compute_q_u``) of the time-sorted data at log-parameters p, through the
    configured whitening engine."""
    f_impl = _filter_fn_of(cfg)

    def at(fn, p):
        with span("gpar.discretize"):
            tl, ts, ol, osig, ns, tns = _unpack_cond(cfg, p)
            time_k = time_kernel_only(cfg.time_family, tl, ts)
            out_k = cfg.out_family(lengthscale=ol, variance=osig**2)
            lgssm = lgssm_of(time_k, t_s, tns**2, cfg.dtype)
        # uu_ridge = s2: the output noise keeps chol(K_uu) stable as K_uu
        # approaches rank one; with separate_noise the LGSSM carries the
        # temporal noise tns and the ridge the output noise ns.
        return fn(
            out_k, lgssm, X_s, Z, y_s, uu_ridge=ns**2, filter_fn=f_impl,
            time_kernel=time_k, t=t_s,
        )

    return at


def fit_conditional(
    generator, t, X_prev, y, cfg: GPARConfig, init_params=None, *, Z=None, device=None
) -> FittedConditional:
    """Type-II ML for one conditional.  ``scaled``: sort by time, pick the
    pseudo-points (``Z`` (M, i-1) if given, else evenly strided rows),
    maximize the DTC bound through the configured whitening engine (Z
    fixed, as in the JAX package), then compute q(u) at the optimum; the
    spans ``gpar.fit``, ``gpar.fit.sort`` and ``gpar.fit.q_u`` name these
    stages, ``gpar.discretize`` each step's LGSSM.  ``exact``: maximize
    the dense exact likelihood under the additive GPAR kernel; the posterior's factors are recomputed from the
    parameters and the data at predict time, as in the JAX package."""
    if cfg.backend not in ("scaled", "exact"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    device = resolve_device(device)
    t, X_prev, y = _as(t, cfg, device), _as(X_prev, cfg, device), _as(y, cfg, device)
    if X_prev.ndim == 1:
        X_prev = X_prev[:, None]
    if cfg.backend == "exact":
        if cfg.separate_noise:
            raise ValueError("separate_noise applies to the scaled backend only")
        x0 = _params(init_params, 5, generator, cfg, device)
        X = _features(t, X_prev)

        def nll(p):
            k, nv = _exact_kernel(cfg, X.shape[1], p)
            return exact_gp.nlml(k, X, y, nv)

        params, res = _train(cfg, nll, x0)
        return FittedConditional(params=params, cfg=cfg, t=t, X_prev=X_prev, y=y,
                                 backend="exact", opt=res)
    with span("gpar.fit"):
        x0 = _params(init_params, 6 if cfg.separate_noise else 5, generator, cfg, device)
        with span("gpar.fit.sort"):
            order = torch.argsort(t, stable=True)
            t_s, X_s, y_s = t[order], X_prev[order], y[order]
            if Z is None:
                Z = _select_pseudo_points(X_s, cfg.num_pseudo_points)
            else:
                Z = _as(Z, cfg, device)
                Z = Z[:, None] if Z.ndim == 1 else Z
        at = _conditional_bound(cfg, t_s, X_s, y_s, Z)
        params, res = _train(cfg, lambda p: -at(dtc_objective, p), x0)
        with torch.no_grad(), span("gpar.fit.q_u"):
            qu = at(compute_q_u, params)
    return FittedConditional(
        params=params, cfg=cfg, t=t_s, X_prev=X_s, y=y_s, backend="scaled", Z=Z, qu=qu,
        opt=res,
    )


def _moved(obj, device):
    """``obj`` with every tensor in it (dataclass fields, tuples, lists)
    moved to ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _moved(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_moved(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_moved(v, device) for v in obj)
    return obj


def fit_conditionals_parallel(
    generator, t, Y, cfg: GPARConfig, init_params: Optional[Sequence] = None, *,
    mesh=None, mesh_axis: str = "chain", device=None,
) -> List[FittedConditional]:
    """Fit conditionals 2..P, each on its own data: conditional i on
    (t, y_1..y_{i-1}) -> y_i.  ``init_params``: one entry (or None) per
    conditional; ``generator`` draws the others, in chain order, before any
    fit starts.

    ``mesh`` (``parallel.mesh.make_mesh``): when the size of its axis
    ``mesh_axis`` divides P - 1, rank r of that axis fits the r-th run of
    (P - 1) / size conditionals, and the fits are all-gathered, so every
    rank returns the same list; every rank draws all the starts, so each fit
    starts where the unsharded one does.  Otherwise the fit runs unsharded
    on every rank, as in the JAX package.

    The JAX package vmaps the conditionals over features zero-padded to
    width P - 1, with the pseudo-points at one row stride for all.  The
    kernels are stationary and isotropic in the outputs, so the zero columns
    leave every distance unchanged, and the stride picks rows only: each
    conditional's padded fit is its unpadded fit, which ``fit_conditional``
    computes.  The port runs them one after the other: its L-BFGS line
    search is per conditional, the scan kernels take one series per call and
    the optimizer syncs once per step, so a batched step would share nothing
    yet (ROADMAP)."""
    device = resolve_device(device)
    Y = _as(Y, cfg, device)
    P = Y.shape[1]
    init_params = list(init_params) if init_params is not None else [None] * (P - 1)
    k = 6 if cfg.separate_noise and cfg.backend == "scaled" else 5
    starts = [_params(init_params[i - 1], k, generator, cfg, device) for i in range(1, P)]

    def fit(i):
        return fit_conditional(None, t, Y[:, :i], Y[:, i], cfg, starts[i - 1], device=device)

    group = None
    if mesh is not None:
        from gpar_at_scale_torch.parallel.mesh import axis_group, axis_rank, axis_size

        size = axis_size(mesh, mesh_axis)
        if size > 1 and (P - 1) % size == 0:
            group, rank = axis_group(mesh, mesh_axis), axis_rank(mesh, mesh_axis)
    if group is None:
        return [fit(i) for i in range(1, P)]
    from gpar_at_scale_torch.parallel.distributed import all_gather_object

    per = (P - 1) // size
    mine = [_moved(fit(i), "cpu") for i in range(1 + rank * per, 1 + (rank + 1) * per)]
    return [_moved(c, device) for part in all_gather_object(mine, group) for c in part]


# ---------------------------------------------------------------------------
# The chained model
# ---------------------------------------------------------------------------


@dataclass
class FittedGPAR:
    first: FittedGP
    conditionals: List[FittedConditional]

    @property
    def num_outputs(self) -> int:
        return 1 + len(self.conditionals)

    def predict(self, t_star):
        """Chained feed-forward prediction: output i conditions on the
        predicted means of outputs 1..i-1.  Returns (means, variances),
        each (N*, P)."""
        means, variances = [], []
        mu1, var1 = self.first.predict(t_star)
        means.append(mu1)
        variances.append(var1)
        for cond in self.conditionals:
            mu, var = cond.predict(t_star, torch.stack(means, dim=1))
            means.append(mu)
            variances.append(var)
        return torch.stack(means, dim=1), torch.stack(variances, dim=1)

    def hyperparams(self):
        return [self.first.hyperparams()] + [c.hyperparams() for c in self.conditionals]


def fit_gpar(
    generator,
    t,
    Y,
    cfg: GPARConfig = GPARConfig(),
    init_params: Optional[Sequence] = None,
    *,
    parallel: bool = False,
    mesh=None,
    mesh_axis: str = "chain",
    device=None,
) -> FittedGPAR:
    """Fit the whole chain: output 1 on time, output i on
    (t, y_1..y_{i-1}).  ``generator`` (a ``torch.Generator`` or None) draws
    the U(0, 1) log-parameters of outputs whose ``init_params`` entry is
    None.  ``parallel`` is the JAX package's switch to its vmapped fit of
    the conditionals, whose fits are the sequential ones
    (``fit_conditionals_parallel``), so both settings fit the same way here.
    ``mesh`` and ``mesh_axis`` split the conditionals over a mesh axis
    (``fit_conditionals_parallel``; the first output is fitted on every
    rank), whatever ``parallel`` says.  Runs on the card unless ``device``
    says otherwise."""
    device = resolve_device(device)
    Y = _as(Y, cfg, device)
    P = Y.shape[1]
    init_params = list(init_params) if init_params is not None else [None] * P
    first = fit_first_output(generator, t, Y[:, 0], cfg, init_params[0], device=device)
    conditionals = fit_conditionals_parallel(generator, t, Y, cfg, init_params[1:], mesh=mesh,
                                             mesh_axis=mesh_axis, device=device)
    return FittedGPAR(first=first, conditionals=conditionals)
