"""GPAR -- Gaussian Process Autoregressive Regression, the model chain.

Counterpart of ``gpar_at_scale_tpu/models/gpar.py``.  Output 1 is a temporal
GP on time; every later output i is a scaled conditional: DTC pseudo-points
over the previous outputs with the temporal LGSSM as structured noise
(``gp/dtc.py``).  Prediction feeds the predicted means down the chain.

This slice serves: ``fit_*`` condition the chain on the hyperparameters
they are given (``max_opt_steps`` must be 0) and compute q(u); ``predict``
answers requests.  Training (``max_opt_steps > 0``), the parallel fit of the
conditionals and the exact backend come with later slices (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

from gpar_at_scale_torch.device import resolve_device
from gpar_at_scale_torch.gp.dtc import QU, compute_q_u, predict_scaled, smoother_for, splice
from gpar_at_scale_torch.kernels import Matern52, time_kernel_only
from gpar_at_scale_torch.ssm.kalman import kalman_filter
from gpar_at_scale_torch.ssm.markov import lgssm_of
from gpar_at_scale_torch.utils.params import init_params, unpack_gp, unpack_gpar, unpack_gpar6

_TRAINING = "hyperparameter training is the next slice of the port (ROADMAP); pass max_opt_steps=0"


@dataclass(frozen=True)
class GPARConfig:
    """Per-model configuration, the JAX package's fields (its ``optimizer``
    comes with training).

    filter_impl: whitening engine of the scaled conditionals --
      'auto'       dense chol(Sigma_y) when N <= gp.dtc.DENSE_N_MAX, the
                   CUDA blocked-scan kernels above;
      'dense'      the dense backend;
      'sequential' the sequential Kalman filter (numerical oracle);
      'pallas'     the CUDA blocked-scan kernels K1-K3 (the JAX package's
                   name for its TPU kernels).
    """

    time_family: Any = Matern52
    out_family: Any = Matern52
    backend: str = "exact"  # 'exact' | 'scaled'
    first_output_backend: str = "temporal"  # 'exact' | 'temporal'
    num_pseudo_points: int = 50
    max_opt_steps: int = 200
    dtype: Any = torch.float64
    filter_impl: str = "auto"
    separate_noise: bool = False


def _check_serving(cfg: GPARConfig) -> None:
    if cfg.max_opt_steps != 0:
        raise NotImplementedError(_TRAINING)


def _unpack_cond(cfg: GPARConfig, p):
    """(time_l, time_sigma, out_l, out_sigma, noise_sigma, time_noise_sigma);
    the 5-parameter pack aliases the temporal noise to the output noise."""
    if cfg.separate_noise:
        return unpack_gpar6(p)
    tl, ts, ol, osig, ns = unpack_gpar(p)
    return tl, ts, ol, osig, ns, ns


def _filter_fn_of(cfg: GPARConfig):
    """GPARConfig.filter_impl -> gp.dtc's filter_fn argument."""
    table = {"auto": None, "dense": "dense", "sequential": kalman_filter, "pallas": "pallas"}
    if cfg.filter_impl not in table:
        raise NotImplementedError(
            f"filter_impl={cfg.filter_impl!r} is not ported yet (ROADMAP P8)"
        )
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
    """First output of the chain: a temporal GP on time."""

    params: torch.Tensor  # (3,) log-params
    cfg: GPARConfig
    t: torch.Tensor
    y: torch.Tensor
    backend: str

    def hyperparams(self) -> Tuple:
        return tuple(float(v) for v in unpack_gp(self.params))

    def predict(self, t_star):
        l, ps, ns = unpack_gp(self.params)
        k = time_kernel_only(self.cfg.time_family, l, ps)
        t_star = _as(t_star, self.cfg, self.t.device)
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


def fit_first_output(generator, t, y, cfg: GPARConfig, init_params=None, *, device=None) -> FittedGP:
    """Condition the temporal GP of output 1 on its hyperparameters.  Only
    the temporal backend is ported; there is nothing to precompute, so the
    fit stores the data sorted by time."""
    _check_serving(cfg)
    if cfg.first_output_backend != "temporal":
        raise NotImplementedError("the exact backend (gp/exact.py) is not ported yet (ROADMAP)")
    device = resolve_device(device)
    t, y = _as(t, cfg, device), _as(y, cfg, device)
    order = torch.argsort(t, stable=True)
    x0 = _params(init_params, 3, generator, cfg, device)
    return FittedGP(params=x0, cfg=cfg, t=t[order], y=y[order], backend="temporal")


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
        time_k, out_k, nv = self._kernels()
        pred = predict_scaled(
            out_k, time_k, self.qu, self.X_prev, self.t, self.y,
            _as(t_star, self.cfg, self.t.device), _as(X_prev_star, self.cfg, self.t.device),
            nv, dtype=self.cfg.dtype,
        )
        return pred.mean, pred.var


def _select_pseudo_points(X, m: int):
    """Evenly strided subset of the inputs as inducing points (the JAX
    package's linspace-and-truncate indices)."""
    n = X.shape[0]
    if m >= n:
        return X
    idx = torch.linspace(0, n - 1, m, dtype=torch.float64).to(torch.int64)
    return X[idx.to(X.device)]


def fit_conditional(
    generator, t, X_prev, y, cfg: GPARConfig, init_params=None, *, device=None
) -> FittedConditional:
    """Condition one scaled conditional on its hyperparameters: sort by time,
    pick the pseudo-points and compute q(u) through the configured
    whitening engine."""
    _check_serving(cfg)
    if cfg.backend != "scaled":
        raise NotImplementedError("the exact backend (gp/exact.py) is not ported yet (ROADMAP)")
    device = resolve_device(device)
    t, X_prev, y = _as(t, cfg, device), _as(X_prev, cfg, device), _as(y, cfg, device)
    if X_prev.ndim == 1:
        X_prev = X_prev[:, None]
    p = _params(init_params, 6 if cfg.separate_noise else 5, generator, cfg, device)
    order = torch.argsort(t, stable=True)
    t_s, X_s, y_s = t[order], X_prev[order], y[order]
    Z = _select_pseudo_points(X_s, cfg.num_pseudo_points)
    tl, ts, ol, osig, ns, tns = _unpack_cond(cfg, p)
    time_k = time_kernel_only(cfg.time_family, tl, ts)
    out_k = cfg.out_family(lengthscale=ol, variance=osig**2)
    lgssm = lgssm_of(time_k, t_s, tns**2, cfg.dtype)
    qu = compute_q_u(
        out_k, lgssm, X_s, Z, y_s, uu_ridge=ns**2, filter_fn=_filter_fn_of(cfg),
        time_kernel=time_k, t=t_s,
    )
    return FittedConditional(
        params=p, cfg=cfg, t=t_s, X_prev=X_s, y=y_s, backend="scaled", Z=Z, qu=qu
    )


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
    device=None,
) -> FittedGPAR:
    """Condition the whole chain: output 1 on time, output i on
    (t, y_1..y_{i-1}).  ``generator`` (a ``torch.Generator`` or None) draws
    the U(0, 1) log-parameters of outputs whose ``init_params`` entry is
    None.  Runs on the card unless ``device`` says otherwise."""
    _check_serving(cfg)
    if parallel:
        raise NotImplementedError("parallel=True fits belong to the training slice (ROADMAP)")
    device = resolve_device(device)
    Y = _as(Y, cfg, device)
    P = Y.shape[1]
    init_params = list(init_params) if init_params is not None else [None] * P
    first = fit_first_output(generator, t, Y[:, 0], cfg, init_params[0], device=device)
    conditionals = [
        fit_conditional(generator, t, Y[:, :i], Y[:, i], cfg, init_params[i], device=device)
        for i in range(1, P)
    ]
    return FittedGPAR(first=first, conditionals=conditionals)
