"""Stationary kernel families: EQ, Matern 1/2, 3/2, 5/2 and rational
quadratic.  Counterpart of ``gpar_at_scale_tpu/kernels/stationary.py``.

k(x, z) = variance * rho(||(x - z) / lengthscale||); the Matern families
have exact state-space forms (``ssm/markov.py``).
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.kernels.base import Kernel, _as_2d, sq_dist

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


class StationaryKernel(Kernel):
    """k(x, z) = variance * rho(r^2), r^2 the squared scaled distance."""

    def __init__(self, lengthscale=1.0, variance=1.0):
        self.lengthscale, self.variance = lengthscale, variance

    def _rho_r2(self, r2):  # pragma: no cover - abstract
        raise NotImplementedError

    def gram(self, x, z):
        l = self.lengthscale
        return self.variance * self._rho_r2(sq_dist(x / l, z / l))

    def diag_part(self, x):
        x = _as_2d(x)
        v = torch.as_tensor(self.variance, dtype=x.dtype, device=x.device)
        return v.expand(x.shape[0])


class EQ(StationaryKernel):
    """Squared exponential: exp(-r^2 / 2)."""

    def _rho_r2(self, r2):
        return torch.exp(-0.5 * r2)


class Matern12(StationaryKernel):
    """exp(-r).  Markov order 1."""

    def _rho_r2(self, r2):
        return torch.exp(-torch.sqrt(r2 + 1e-36))


class Matern32(StationaryKernel):
    """(1 + sqrt3 r) exp(-sqrt3 r).  Markov order 2."""

    def _rho_r2(self, r2):
        s = _SQRT3 * torch.sqrt(r2 + 1e-36)
        return (1.0 + s) * torch.exp(-s)


class Matern52(StationaryKernel):
    """(1 + sqrt5 r + 5 r^2 / 3) exp(-sqrt5 r).  Markov order 3."""

    def _rho_r2(self, r2):
        s = _SQRT5 * torch.sqrt(r2 + 1e-36)
        return (1.0 + s + (5.0 / 3.0) * r2) * torch.exp(-s)


class RQ(StationaryKernel):
    """Rational quadratic: (1 + r^2 / (2 alpha))^(-alpha)."""

    def __init__(self, lengthscale=1.0, variance=1.0, alpha=1.0):
        super().__init__(lengthscale, variance)
        self.alpha = alpha

    def _rho_r2(self, r2):
        return (1.0 + r2 / (2.0 * self.alpha)) ** (-self.alpha)


def scaled(base_cls, lengthscale, variance_sq_root=None, *, variance=None, **extra):
    """Stheno-style ``kernel(k; l=l, s=s)`` constructor: ``base_cls`` with
    the given lengthscale and either ``variance`` or ``variance_sq_root``
    (sigma, squared here), as in the JAX package."""
    if variance is None:
        variance = variance_sq_root**2
    return base_cls(lengthscale=lengthscale, variance=variance, **extra)
