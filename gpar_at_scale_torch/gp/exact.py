"""Exact dense Gaussian-process regression.

Counterpart of ``gpar_at_scale_tpu/gp/exact.py``: the exact log marginal
likelihood, conditioning, and the posterior's predictive.  Every
factorization and solve goes through ``utils/psd.py``, so with
``engine.pallas_dense`` switched on they run on K6a (``cholesky_psd``), K6b
(``solve_lower``) and K6c (``solve_upper``) for float32 matrices of
8 <= N <= 512.  Differentiable in the kernel's hyperparameters by autograd.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gpar_at_scale_torch.kernels.base import Kernel, _as_2d
from gpar_at_scale_torch.utils.psd import cho_solve, cholesky_psd, logdet_from_chol, solve_lower

_LOG_2PI = 1.8378770664093453


def _noisy_gram(kernel: Kernel, x, noise_var, n):
    K = kernel(x, x)
    noise = torch.as_tensor(noise_var, dtype=K.dtype, device=K.device).expand(n)
    return K + torch.diag(noise)


def log_marginal_likelihood(kernel: Kernel, x, y, noise_var, mean=0.0):
    """log N(y | mean, K + noise_var I); ``noise_var`` a scalar or an (N,)
    vector."""
    x = _as_2d(x)
    n = y.shape[0]
    L = cholesky_psd(_noisy_gram(kernel, x, noise_var, n))
    alpha = solve_lower(L, y - mean)
    return -0.5 * (n * _LOG_2PI + logdet_from_chol(L) + (alpha * alpha).sum())


def nlml(kernel: Kernel, x, y, noise_var, mean=0.0):
    return -log_marginal_likelihood(kernel, x, y, noise_var, mean)


@dataclass
class GPPosterior:
    """A conditioned GP with its cached Cholesky factor.

    Predictive mean = K_*f alpha, variance = k_** - |L^-1 K_f*|^2."""

    kernel: Kernel
    x_train: torch.Tensor  # (N, D)
    chol: torch.Tensor  # (N, N) lower
    alpha: torch.Tensor  # (N,) = (K + S)^-1 (y - mean)
    mean_const: torch.Tensor  # scalar prior mean

    def predict_f(self, x_star, diag: bool = True):
        """Latent-function posterior at x_star: (mean, variance) or, with
        ``diag=False``, (mean, covariance)."""
        xs = _as_2d(x_star)
        Ksf = self.kernel(xs, self.x_train)  # (N*, N)
        mean = self.mean_const + Ksf @ self.alpha
        V = solve_lower(self.chol, Ksf.T)  # (N, N*)
        if diag:
            var = self.kernel.diag_part(xs) - (V * V).sum(0)
            return mean, torch.clamp(var, min=0.0)
        return mean, self.kernel(xs, xs) - V.T @ V

    def predict_y(self, x_star, noise_var):
        """Observation-space posterior: the variances carry the noise."""
        mean, var = self.predict_f(x_star, diag=True)
        return mean, var + noise_var

    def logpdf_train(self, y):
        """log-likelihood of the training data under the cached factor."""
        resid = y - self.mean_const
        a = solve_lower(self.chol, resid)
        n = resid.shape[0]
        return -0.5 * (n * _LOG_2PI + logdet_from_chol(self.chol) + (a * a).sum())

    def sample_f(self, generator: torch.Generator, x_star, num_samples: int = 1):
        """Joint posterior samples at x_star, (num_samples, N*); the normal
        draws come from ``generator`` (on the tensors' device)."""
        mean, cov = self.predict_f(x_star, diag=False)
        L = cholesky_psd(cov)
        eps = torch.randn((num_samples, mean.shape[0]), generator=generator, dtype=mean.dtype,
                          device=mean.device)
        return mean[None, :] + eps @ L.T


def condition(kernel: Kernel, x, y, noise_var, mean=0.0) -> GPPosterior:
    """The posterior f | (f(x) + noise = y)."""
    x = _as_2d(x)
    n = y.shape[0]
    L = cholesky_psd(_noisy_gram(kernel, x, noise_var, n))
    alpha = cho_solve(L, y - mean)
    return GPPosterior(kernel=kernel, x_train=x, chol=L, alpha=alpha,
                       mean_const=torch.as_tensor(mean, dtype=L.dtype, device=L.device))
