"""Collapsed variational inference (Titsias) for sparse GPs.

Counterpart of ``gpar_at_scale_tpu/inference/vi.py``: the collapsed bound
lives in ``gp/dtc.py::titsias_elbo``; this module maximizes it jointly over
the kernel hyperparameters, the noise and (optionally) the inducing inputs
Z with the L-BFGS or Adam drivers of ``inference/optimize.py``.  The
optimal q(u) is recovered in closed form afterwards, so there are no
variational parameters beyond Z.  Its factorizations and solves go through
``utils/psd.py``, so K6a-c take them under ``engine.pallas_dense``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpar_at_scale_torch.device import resolve_device
from gpar_at_scale_torch.gp.dtc import predict_sparse_iid, titsias_elbo
from gpar_at_scale_torch.inference.optimize import OptResult, minimize_adam, minimize_lbfgs
from gpar_at_scale_torch.utils.params import unpack_gp


class SparseVIResult(NamedTuple):
    log_params: torch.Tensor  # (3,) optimized (log_l, log_sigma_f, log_sigma_n)
    Z: torch.Tensor  # (M, D) optimized inducing inputs
    elbo: torch.Tensor  # final bound value
    num_steps: int


def fit_sparse_vi(
    generator: torch.Generator,
    kernel_family,
    x,
    y,
    num_inducing: int,
    *,
    learn_inducing: bool = True,
    init_log_params=None,
    optimizer: str = "lbfgs",
    max_steps: int = 300,
    device=None,
) -> SparseVIResult:
    """Maximize the Titsias collapsed ELBO.  The inducing inputs start at an
    even-strided subset of the inputs and, with ``learn_inducing``, are
    optimized with the hyperparameters (the bound's trace term keeps them
    apart).  Without ``init_log_params`` the start is 0.3 N(0, 1) from
    ``generator``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    x = x[:, None] if x.ndim == 1 else x
    y = torch.as_tensor(y).to(device=dev, dtype=x.dtype)
    dtype = x.dtype
    n, D = x.shape
    m = min(num_inducing, n)
    Z0 = x[torch.as_tensor(np.linspace(0, n - 1, m).astype(np.int64), device=dev)]
    if init_log_params is not None:
        p0 = torch.as_tensor(init_log_params).to(device=dev, dtype=dtype)
    else:
        p0 = 0.3 * torch.randn(3, generator=generator, dtype=dtype,
                               device=generator.device).to(dev)

    def unpack(theta):
        return theta[:3], (theta[3:].reshape(m, D) if learn_inducing else Z0)

    def objective(theta):
        log_params, Z = unpack(theta)
        l, sf, sn = unpack_gp(log_params)
        return -titsias_elbo(kernel_family(lengthscale=l, variance=sf**2), x, Z, y, sn**2)

    theta0 = torch.cat([p0, Z0.reshape(-1)]) if learn_inducing else p0
    minimize = minimize_lbfgs if optimizer == "lbfgs" else minimize_adam
    res: OptResult = minimize(objective, theta0, max_steps=max_steps)
    log_params, Z = unpack(res.params)
    return SparseVIResult(log_params=log_params, Z=Z, elbo=-res.value, num_steps=res.num_steps)


def predict_sparse_vi(result: SparseVIResult, kernel_family, x, y, x_star):
    """Posterior predictive (mean, latent variance) under the fitted sparse
    model, on the result's device and dtype."""
    like = result.log_params
    x, y, x_star = (torch.as_tensor(a).to(device=like.device, dtype=like.dtype)
                    for a in (x, y, x_star))
    l, sf, sn = unpack_gp(result.log_params)
    k = kernel_family(lengthscale=l, variance=sf**2)
    return predict_sparse_iid(k, x, result.Z, y, sn**2, x_star)
