"""Hyperparameter packing and the positivity transform.

Counterpart of ``gpar_at_scale_tpu/utils/params.py``.  Log-parameters map to
the positive reals with ``exp(p) + 1e-3`` (the reference's transform), so
log-parameters carry across the two packages unchanged.

GP parameter vector (3,):    [log_l, log_process_sigma, log_noise_sigma]
GPAR parameter vector (5,):  [log_time_l, log_time_sigma, log_out_l,
                              log_out_sigma, log_noise_sigma]
Separate-noise vector (6,):  the five above + log_time_noise_sigma
"""

from __future__ import annotations

import torch

_SHIFT = 1e-3


def constrain(log_p):
    """Map an unconstrained log-parameter to a positive value: exp(p) + 1e-3."""
    return torch.exp(log_p) + _SHIFT


def unconstrain(p):
    """Inverse of :func:`constrain`; raises for p <= 1e-3, which has no
    preimage."""
    p = torch.as_tensor(p, dtype=torch.float64) if not torch.is_tensor(p) else p
    if bool(torch.any(p <= _SHIFT)):
        raise ValueError(
            f"unconstrain: parameter value {p} must be > {_SHIFT} "
            "(the positivity transform is exp(x) + 1e-3)"
        )
    return torch.log(p - _SHIFT)


def unpack_gp(params):
    """(3,) log-params -> (lengthscale, process_sigma, noise_sigma)."""
    return constrain(params[0]), constrain(params[1]), constrain(params[2])


def unpack_gpar(params):
    """(5,) log-params -> (time_l, time_sigma, out_l, out_sigma, noise_sigma)."""
    return tuple(constrain(params[i]) for i in range(5))


def unpack_gpar6(params):
    """(6,) log-params -> (time_l, time_sigma, out_l, out_sigma, noise_sigma,
    time_noise_sigma); the sixth is the temporal observation noise, learned
    apart from the output noise."""
    return tuple(constrain(params[i]) for i in range(6))


def _pack(*values):
    return torch.stack([unconstrain(v) for v in values])


def pack_gp(l, process_sigma, noise_sigma):
    return _pack(l, process_sigma, noise_sigma)


def pack_gpar(time_l, time_sigma, out_l, out_sigma, noise_sigma):
    return _pack(time_l, time_sigma, out_l, out_sigma, noise_sigma)


def pack_gpar6(time_l, time_sigma, out_l, out_sigma, noise_sigma, time_noise_sigma):
    return _pack(time_l, time_sigma, out_l, out_sigma, noise_sigma, time_noise_sigma)


def init_params(n: int, generator: torch.Generator, dtype, device):
    """U(0, 1) initial log-parameters (the reference's random init)."""
    return torch.rand(n, generator=generator, dtype=dtype).to(device)
