"""Reference-named convenience API.

Counterpart of ``gpar_at_scale_tpu/api.py``: one-call functions under the
reference's exported names, each mapped onto the class-based API of
``models/``, ``gp/`` and ``ssm/``.  Each takes a ``torch.Generator`` where
the JAX package takes a PRNG key, and a ``device`` (the card unless the
caller passes ``device="cpu"``); inputs may be numpy arrays or tensors.

Reference export                     -> here
---------------------------------------------------------------------------
create_optim_gp / _post              -> fit_gp            (posterior incl.)
create_optim_gpar / _post            -> fit_gpar_conditional
create_lgssm                         -> gpar_at_scale_torch.ssm.lgssm_of
get_sde_predictions                  -> get_sde_predictions
get_optim_scaled_gpar_params         -> get_optim_scaled_gpar_params
compute_gpar_dtc_objective           -> gpar_at_scale_torch.gp.dtc_objective
get_gpar_scaled_predictions          -> get_gpar_scaled_predictions
compute_q_u                          -> gpar_at_scale_torch.gp.compute_q_u
generate_small/big_dataset           -> gpar_at_scale_torch.data.*
to_ColVecs                           -> plain (N, D) arrays (row = point)
unpack_gp / unpack_gpar / parse_*    -> gpar_at_scale_torch.utils.*

The scaled functions whiten through ``gp/dtc.py``'s automatic dispatch:
dense up to ``DENSE_N_MAX`` steps, the float32 scan kernels (K1-K5) above
it.  The JAX package's api passes no time kernel there, so it runs its
sequential filter at every N; both compute the same bound.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gpar_at_scale_torch.device import resolve_device
from gpar_at_scale_torch.gp.dtc import compute_q_u, dtc_objective, predict_scaled
from gpar_at_scale_torch.kernels import Matern52, time_kernel_only
from gpar_at_scale_torch.kernels.base import _as_2d
from gpar_at_scale_torch.models.gpar import (
    GPARConfig,
    _train,
    fit_conditional,
    fit_first_output,
)
from gpar_at_scale_torch.ssm.markov import lgssm_of
from gpar_at_scale_torch.utils.params import init_params, unpack_gpar

_F64 = torch.float64


def fit_gp(
    generator,
    input_locations,
    outputs,
    *,
    kernel_family=Matern52,
    init_log_params=None,
    backend: str = "exact",
    max_opt_steps: int = 200,
    device=None,
):
    """Type-II-ML GP on 1-D inputs with its posterior (the reference's
    ``create_optim_gp_post``).  Returns the fitted model: ``.predict(t_star)``
    gives the marginals, ``.hyperparams()`` (l, process_sigma, noise_sigma)."""
    cfg = GPARConfig(
        time_family=kernel_family, first_output_backend=backend, max_opt_steps=max_opt_steps
    )
    return fit_first_output(generator, input_locations, outputs, cfg, init_log_params,
                            device=device)


def fit_gpar_conditional(
    generator,
    time_locations,
    prev_outputs,
    outputs,
    *,
    time_family=Matern52,
    out_family=Matern52,
    backend: str = "exact",
    num_pseudo_points: int = 50,
    init_log_params=None,
    max_opt_steps: int = 200,
    device=None,
):
    """One conditional of the chain over (t, y_prev) (the reference's
    ``create_optim_gpar_post`` for backend='exact', the scaled pipeline for
    backend='scaled')."""
    cfg = GPARConfig(
        time_family=time_family,
        out_family=out_family,
        backend=backend,
        num_pseudo_points=num_pseudo_points,
        max_opt_steps=max_opt_steps,
    )
    return fit_conditional(generator, time_locations, prev_outputs, outputs, cfg,
                           init_log_params, device=device)


def get_sde_predictions(
    generator,
    data_locations,
    data_outputs,
    output_locations,
    *,
    kernel_family=Matern52,
    init_log_params=None,
    max_opt_steps: int = 200,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(N) temporal-GP regression: hyperparameters by the Kalman
    likelihood, then (means, variances) at ``output_locations`` through the
    infinite-noise splice (the reference's ``get_sde_predictions``)."""
    fit = fit_gp(
        generator,
        data_locations,
        data_outputs,
        kernel_family=kernel_family,
        init_log_params=init_log_params,
        backend="temporal",
        max_opt_steps=max_opt_steps,
        device=device,
    )
    return fit.predict(output_locations)


def _scaled_data(input_locations, pseudo_input_locations, time_loc, outputs, device):
    """(t_s, V_s, y_s, Z): the float64 data sorted by time, inputs as
    (N, D) and pseudo-inputs as (M, D) whichever way round they came."""
    as64 = lambda a: torch.as_tensor(a).to(device, _F64)  # noqa: E731
    t = as64(time_loc)
    order = torch.argsort(t, stable=True)
    V = torch.atleast_2d(as64(input_locations))
    if V.shape[0] != t.shape[0]:
        V = V.T
    Z = torch.atleast_2d(as64(pseudo_input_locations))
    if Z.shape[1] != V.shape[1]:
        Z = Z.T
    return t[order], V[order], as64(outputs)[order], Z


def _scaled_model(hyper, t_s, time_family, out_family):
    """(time kernel, output kernel, LGSSM of the series, noise variance) at
    the 5 hyperparameters (time_l, time_sigma, out_l, out_sigma, noise_sigma)."""
    tl, ts, ol, osig, ns = hyper
    time_k = time_kernel_only(time_family, tl, ts)
    out_k = out_family(lengthscale=ol, variance=osig**2)
    return time_k, out_k, lgssm_of(time_k, t_s, ns**2, _F64), ns**2


def get_optim_scaled_gpar_params(
    generator,
    input_locations,
    pseudo_input_locations,
    time_loc,
    outputs,
    *,
    out_family=Matern52,
    time_family=Matern52,
    init_log_params=None,
    max_opt_steps: int = 200,
    device=None,
):
    """The 5 shared hyperparameters of the scaled conditional by L-BFGS on
    the DTC bound (the reference's ``get_optim_scaled_gpar_params``).
    Returns (time_l, time_sigma, out_l, out_sigma, noise_sigma)."""
    device = resolve_device(device)
    t_s, V_s, y_s, Z = _scaled_data(input_locations, pseudo_input_locations, time_loc, outputs,
                                    device)
    x0 = (torch.as_tensor(init_log_params).to(device, _F64) if init_log_params is not None
          else init_params(5, generator, _F64, device))

    def nlml(p):
        time_k, out_k, lgssm, nv = _scaled_model(unpack_gpar(p), t_s, time_family, out_family)
        return -dtc_objective(out_k, lgssm, V_s, Z, y_s, uu_ridge=nv, time_kernel=time_k, t=t_s)

    params, _ = _train(GPARConfig(max_opt_steps=max_opt_steps), nlml, x0)
    return tuple(float(v) for v in unpack_gpar(params))


def get_gpar_scaled_predictions(
    generator,
    input_locations,
    pseudo_input_locations,
    time_loc,
    outputs,
    inference_time_loc,
    inference_input_locations,
    *,
    out_family=Matern52,
    time_family=Matern52,
    init_log_params=None,
    max_opt_steps: int = 200,
    num_samples: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scaled pipeline end to end: hyperparameters by the DTC bound,
    q(u), then (means, standard deviations) at the inference locations (the
    reference's ``get_gpar_scaled_predictions``).  ``num_samples=0`` gives
    the exact analytic predictive; ``num_samples > 0`` the reference's
    Monte-Carlo estimate (it used 100 samples), drawn from ``generator``,
    which then must be given."""
    device = resolve_device(device)
    if num_samples > 0 and generator is None:
        raise ValueError("num_samples > 0 requires a torch.Generator")
    params = get_optim_scaled_gpar_params(
        generator,
        input_locations,
        pseudo_input_locations,
        time_loc,
        outputs,
        out_family=out_family,
        time_family=time_family,
        init_log_params=init_log_params,
        max_opt_steps=max_opt_steps,
        device=device,
    )
    t_s, V_s, y_s, Z = _scaled_data(input_locations, pseudo_input_locations, time_loc, outputs,
                                    device)
    hyper = torch.tensor(params, dtype=_F64, device=device)
    time_k, out_k, lgssm, nv = _scaled_model(hyper, t_s, time_family, out_family)
    qu = compute_q_u(out_k, lgssm, V_s, Z, y_s, uu_ridge=nv, time_kernel=time_k, t=t_s)
    as64 = lambda a: torch.as_tensor(a).to(device, _F64)  # noqa: E731
    pred = predict_scaled(
        out_k, time_k, qu, V_s, t_s, y_s, as64(inference_time_loc),
        _as_2d(as64(inference_input_locations)), nv, num_samples=num_samples,
        generator=generator,
    )
    return pred.mean, torch.sqrt(pred.var)
