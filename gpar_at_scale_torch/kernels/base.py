"""Covariance-kernel core: kernel classes and combinators.

Counterpart of ``gpar_at_scale_tpu/kernels/base.py``.  A kernel is a small
class holding its hyperparameter tensors; ``k(x, z)`` is the cross-covariance
matrix and ``k.diag_part(x)`` its diagonal at ``x``.  Inputs are ``(N, D)``
tensors (a 1-D input is read as ``(N, 1)``).
"""

from __future__ import annotations

from typing import Tuple

import torch


class Kernel:
    """Abstract kernel.  Subclasses implement ``gram`` and ``diag_part``."""

    def __call__(self, x, z=None):
        x = _as_2d(x)
        z = x if z is None else _as_2d(z)
        return self.gram(x, z)

    def gram(self, x, z):  # pragma: no cover - abstract
        raise NotImplementedError

    def diag_part(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def __add__(self, other):
        return Sum(self, _as_kernel(other))

    def __mul__(self, other):
        if isinstance(other, Kernel):
            return Product(self, other)
        return ScaledKernel(self, other)

    __rmul__ = __mul__

    def select(self, dims):
        """Restrict the kernel to a static subset of input columns (the
        reference's 0/1 ``stretch`` masks)."""
        return SelectDims(self, tuple(int(d) for d in dims))


def _as_2d(x):
    return x[:, None] if x.ndim == 1 else x


def _as_kernel(k):
    if not isinstance(k, Kernel):
        raise TypeError(f"expected Kernel, got {type(k)}")
    return k


def sq_dist(x, z):
    """Pairwise squared Euclidean distances ||x||^2 + ||z||^2 - 2 <x, z>,
    clamped at 0 against cancellation (full-precision matmul: see
    ``device.py``).  Leading batch axes broadcast: x (..., N, D) scaled by
    a batch of lengthscales gives a batch of distance matrices."""
    xn = (x * x).sum(-1)
    zn = (z * z).sum(-1)
    d2 = xn[..., :, None] + zn[..., None, :] - 2.0 * (x @ z.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


class Sum(Kernel):
    """k1 + k2: the GPAR additive kernel split."""

    def __init__(self, left: Kernel, right: Kernel):
        self.left, self.right = left, right

    def gram(self, x, z):
        return self.left.gram(x, z) + self.right.gram(x, z)

    def diag_part(self, x):
        return self.left.diag_part(x) + self.right.diag_part(x)


class Product(Kernel):
    def __init__(self, left: Kernel, right: Kernel):
        self.left, self.right = left, right

    def gram(self, x, z):
        return self.left.gram(x, z) * self.right.gram(x, z)

    def diag_part(self, x):
        return self.left.diag_part(x) * self.right.diag_part(x)


class ScaledKernel(Kernel):
    """variance * k."""

    def __init__(self, base: Kernel, variance):
        self.base, self.variance = base, variance

    def gram(self, x, z):
        return self.variance * self.base.gram(x, z)

    def diag_part(self, x):
        return self.variance * self.base.diag_part(x)


class SelectDims(Kernel):
    """Evaluate ``base`` on a static subset of input columns."""

    def __init__(self, base: Kernel, dims: Tuple[int, ...] = ()):
        self.base, self.dims = base, tuple(dims)

    def _sel(self, x):
        return x[..., list(self.dims)] if self.dims else x

    def gram(self, x, z):
        return self.base.gram(self._sel(x), self._sel(z))

    def diag_part(self, x):
        return self.base.diag_part(self._sel(_as_2d(x)))


class LinearMapKernel(Kernel):
    """k(Ax, Az) for a general (P, D) matrix A."""

    def __init__(self, base: Kernel, A):
        self.base, self.A = base, A

    def gram(self, x, z):
        return self.base.gram(x @ self.A.T, z @ self.A.T)

    def diag_part(self, x):
        return self.base.diag_part(_as_2d(x) @ self.A.T)
