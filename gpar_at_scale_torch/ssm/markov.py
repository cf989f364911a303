"""Markovian (state-space) forms of Matern-family kernels.

Counterpart of ``gpar_at_scale_tpu/ssm/markov.py``.  A Matern-(2p+1)/2 GP on
1-D time is the first component of a d = p+1 dimensional LTI SDE
dx = F x dt + L dW, discretized over sorted times into the LGSSM

    x_k = A_k x_{k-1} + q_k,  q_k ~ N(0, Q_k),   x_0 ~ N(0, Pinf)
    y_k = H x_k + e_k,        e_k ~ N(0, R_k)

with A_k = expm(F dt_k) and Q_k = Pinf - A_k Pinf A_k^T.  A single Matern
block's F has characteristic polynomial (s + lam)^d, so N = F + lam I is
nilpotent and expm(F dt) = exp(-lam dt) (I + N dt + N^2 dt^2 / 2) in closed
form.  Sums of Markovian kernels are block-diagonal states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from gpar_at_scale_torch.kernels.base import Kernel, ScaledKernel, Sum
from gpar_at_scale_torch.kernels.stationary import Matern12, Matern32, Matern52
from gpar_at_scale_torch.utils.observability import host_sync

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


@dataclass(frozen=True)
class SDEBlock:
    """One single-family LTI SDE block with eigenvalue -lam (multiplicity d)."""

    F: torch.Tensor  # (d, d)
    Pinf: torch.Tensor  # (d, d)
    H: torch.Tensor  # (d,)
    lam: torch.Tensor  # scalar > 0

    @property
    def dim(self) -> int:
        return self.F.shape[-1]


@dataclass(frozen=True)
class SDE:
    """A Markovian prior as a tuple of blocks (sum kernel = block-diagonal
    state; emission rows concatenate)."""

    blocks: Tuple[SDEBlock, ...]

    @property
    def dim(self) -> int:
        return sum(b.dim for b in self.blocks)


@dataclass(frozen=True)
class LGSSM:
    """Discrete linear-Gaussian SSM over a time grid.

    A: (N, d, d) transitions (A_0 = 0: x_0 is drawn from N(0, Q_0)).
    Q: (N, d, d) process noise (Q_0 = Pinf).
    H: (d,) emission row.
    R: (N,) per-point observation noise variance (the 1e10 test-point splice
       of the predictive needs it per point).
    e1: whether H = e1 (one Matern block), where the code that builds the
       LGSSM knows it on the host; None where it does not
       (``ops.kalman.pallas_supported`` then reads H back).
    """

    A: torch.Tensor
    Q: torch.Tensor
    H: torch.Tensor
    R: torch.Tensor
    e1: Optional[bool] = None

    @property
    def num_steps(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[-1]


def _matern_block(d: int, l, s):
    """(F, Pinf, H, lam) of the Matern block with state dim d.  l and s are
    scalars, or (B,) tensors for B blocks at once: F and Pinf are then
    (B, d, d) and lam (B,)."""
    z = torch.zeros_like(l)
    o = torch.ones_like(l)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    if d == 1:
        lam = 1.0 / l
        F = (-lam)[..., None, None]
        Pinf = (s * o)[..., None, None]
    elif d == 2:
        lam = _SQRT3 / l
        F = mat([[z, o], [-(lam**2), -2.0 * lam]])
        Pinf = mat([[s * o, z], [z, s * lam**2]])
    else:
        lam = _SQRT5 / l
        F = mat([[z, o, z], [z, z, o], [-(lam**3), -3.0 * lam**2, -3.0 * lam]])
        kappa = s * lam**2 / 3.0
        Pinf = mat([[s * o, z, -kappa], [z, kappa, z], [-kappa, z, lam**4 * s]])
    H = torch.zeros(d, dtype=l.dtype, device=l.device)
    H[0] = 1.0
    host_sync()  # a host scalar written into a device tensor: a blocking copy
    return SDEBlock(F=F, Pinf=Pinf, H=H, lam=lam)


_ORDER = {Matern12: 1, Matern32: 2, Matern52: 3}


def to_sde(kernel: Kernel, dtype=torch.float64, device=None) -> SDE:
    """Convert a Markovian kernel (Matern12/32/52, scalings and sums of them)
    to its LTI SDE.  Raises TypeError for non-Markovian kernels (EQ, RQ)."""
    return SDE(blocks=tuple(_blocks_of(kernel, dtype, device, 1.0)))


def _blocks_of(kernel, dtype, device, outer_scale):
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    if type(kernel) in _ORDER:
        return [
            _matern_block(
                _ORDER[type(kernel)],
                as_t(kernel.lengthscale),
                outer_scale * as_t(kernel.variance),
            )
        ]
    if isinstance(kernel, ScaledKernel):
        return _blocks_of(kernel.base, dtype, device, outer_scale * as_t(kernel.variance))
    if isinstance(kernel, Sum):
        return _blocks_of(kernel.left, dtype, device, outer_scale) + _blocks_of(
            kernel.right, dtype, device, outer_scale
        )
    raise TypeError(
        f"kernel {type(kernel).__name__} has no exact finite-dimensional SDE "
        "(only Matern 1/2, 3/2, 5/2 and scalings/sums thereof are Markovian)"
    )


def _expm_block(block: SDEBlock, dt):
    """Closed-form expm(F dt) for a vector of gaps dt (n,) -> (n, d, d),
    via the nilpotent split F = -lam I + N; (B, n, d, d) for a block of B
    (``_matern_block`` with (B,) hyperparameters)."""
    d = block.dim
    I = torch.eye(d, dtype=block.F.dtype, device=block.F.device)
    N = (block.F + block.lam[..., None, None] * I)[..., None, :, :]
    dt3 = dt[:, None, None]
    out = I + N * dt3
    if d >= 3:
        out = out + (N @ N) * (dt3 * dt3 * 0.5)
    return torch.exp(-block.lam[..., None, None, None] * dt3) * out


def _q_block(block: SDEBlock, dt):
    """Q = Pinf - A Pinf A^T of one block for gaps dt (n,) -> (n, d, d), in
    closed form ((B, n, d, d) for a block of B).  With
    A = exp(-lam dt) sum_i dt^i N^i / i!,
    A Pinf A^T = exp(-2 lam dt) sum_p dt^p B_p with
    B_p = sum_{i+j=p} N^i Pinf (N^j)^T / (i! j!), a polynomial in dt with
    d x d coefficients (Horner below): elementwise work over the n gaps,
    where a batched n x (d x d) product runs far below the card's rate."""
    d = block.dim
    I = torch.eye(d, dtype=block.F.dtype, device=block.F.device)
    N = block.F + block.lam[..., None, None] * I
    Np = [I]
    for _ in range(d - 1):
        Np.append(Np[-1] @ N)
    fact = (1.0, 1.0, 0.5)
    B = [torch.zeros_like(block.Pinf) for _ in range(2 * d - 1)]
    for i in range(d):
        for j in range(d):
            B[i + j] = B[i + j] + (fact[i] * fact[j]) * (Np[i] @ block.Pinf @ Np[j].transpose(-1, -2))
    B = [Bp[..., None, :, :] for Bp in B]
    dt3 = dt[:, None, None]
    acc = B[-1]
    for Bp in reversed(B[:-1]):
        acc = acc * dt3 + Bp
    return block.Pinf[..., None, :, :] - torch.exp(-2.0 * block.lam[..., None, None, None] * dt3) * acc


def _block_diag_batched(mats):
    """Block-diagonal assembly of a list of (n, d_i, d_i) stacks."""
    n = mats[0].shape[0]
    D = sum(m.shape[-1] for m in mats)
    out = mats[0].new_zeros((n, D, D))
    o = 0
    for m in mats:
        k = m.shape[-1]
        out[:, o : o + k, o : o + k] = m
        o += k
    return out


def discretize(sde: SDE, t, noise_var) -> LGSSM:
    """Index the SDE at sorted times t (N,) with observation noise (scalar or
    per-point (N,)).  Raises ValueError on an unsorted grid: negative gaps
    would give an indefinite Q and NaNs downstream."""
    F0 = sde.blocks[0].F
    t = torch.as_tensor(t, dtype=F0.dtype, device=F0.device)
    n = t.shape[0]
    dts = torch.diff(t)
    unsorted = bool((dts < 0).any())
    host_sync()
    if unsorted:
        raise ValueError(
            "discretize: time grid must be sorted ascending (got negative time gaps)"
        )

    A_blocks = [_expm_block(b, dts) for b in sde.blocks]
    Q_blocks = [_q_block(b, dts) for b in sde.blocks]
    if len(sde.blocks) == 1:
        A_steps, Q_steps, Pinf, H = A_blocks[0], Q_blocks[0], sde.blocks[0].Pinf, sde.blocks[0].H
    else:
        A_steps, Q_steps = _block_diag_batched(A_blocks), _block_diag_batched(Q_blocks)
        Pinf = torch.block_diag(*[b.Pinf for b in sde.blocks])
        H = torch.cat([b.H for b in sde.blocks])

    d = sde.dim
    A = torch.cat([A_steps.new_zeros((1, d, d)), A_steps], dim=0)
    Q = torch.cat([Pinf[None], Q_steps], dim=0)
    Q = 0.5 * (Q + Q.transpose(-1, -2))  # symmetrize against rounding
    R = torch.as_tensor(noise_var, dtype=t.dtype, device=t.device).expand(n).contiguous()
    return LGSSM(A=A, Q=Q, H=H, R=R, e1=len(sde.blocks) == 1)


def lgssm_of(kernel: Kernel, t, noise_var, dtype=None) -> LGSSM:
    """``to_sde`` + ``discretize`` (the reference's ``create_lgssm``).
    ``dtype`` defaults to t's; the device is t's.

    The discretization runs in float64 and its result is cast to ``dtype``
    (the JAX package discretizes in ``dtype``).  Q = Pinf - A Pinf A^T
    cancels down to O(dt) of Pinf: in float32 at gaps of 1e-3 that cost the
    time-variance component of the DTC gradient 1.2% on the chain data at
    N = 2500, and 2e-4 once Q is formed in float64
    (``tests/test_torch_port.py``).  The O(N) scans after it stay in
    ``dtype``."""
    t = torch.as_tensor(t)
    dtype = t.dtype if dtype is None else dtype
    f64 = torch.float64
    lg = discretize(to_sde(kernel, f64, t.device), t.to(f64), noise_var)
    return LGSSM(A=lg.A.to(dtype), Q=lg.Q.to(dtype), H=lg.H.to(dtype), R=lg.R.to(dtype),
                 e1=lg.e1)


def lgssm_batch_of(kernel: Kernel, t, noise_var, dtype=None) -> LGSSM:
    """B Matern time GPs on one sorted grid t (N,) as one LGSSM of B N
    steps, the B series laid end to end: ``kernel`` is a Matern12/32/52
    whose lengthscale and variance are (B,) tensors, ``noise_var`` (B,) or
    (B, N).  Series b is steps [b N, (b + 1) N) and ``lgssm_of`` of its
    own kernel; its first step has A = 0 and Q = Pinf, so a filter restarts
    from the prior there and a smoother's gain into it is zero: the scan
    engines take the B series as one without mixing them.

    The discretization runs in float64 for all B at once and is cast to
    ``dtype`` (t's by default), as ``lgssm_of``; the host waits as often as
    for one series."""
    if type(kernel) not in _ORDER:
        raise TypeError(f"lgssm_batch_of takes a Matern kernel, got {type(kernel).__name__}")
    t = torch.as_tensor(t)
    dtype = t.dtype if dtype is None else dtype
    f64 = torch.float64
    as64 = lambda v: torch.as_tensor(v, dtype=f64, device=t.device)  # noqa: E731
    ell, var = as64(kernel.lengthscale), as64(kernel.variance)
    if ell.ndim != 1 or var.shape != ell.shape:
        raise ValueError(f"lgssm_batch_of takes (B,) hyperparameters, got {tuple(ell.shape)}, "
                         f"{tuple(var.shape)}")
    b, n = ell.shape[0], t.shape[0]
    block = _matern_block(_ORDER[type(kernel)], ell, var)
    t = t.to(f64)
    dts = torch.diff(t)
    unsorted = bool((dts < 0).any())
    host_sync()
    if unsorted:
        raise ValueError("lgssm_batch_of: time grid must be sorted ascending (got negative time gaps)")
    d = block.dim
    A = torch.cat([block.F.new_zeros((b, 1, d, d)), _expm_block(block, dts)], dim=1)
    Q = torch.cat([block.Pinf[:, None], _q_block(block, dts)], dim=1)
    Q = 0.5 * (Q + Q.transpose(-1, -2))
    R = as64(noise_var)
    R = (R[:, None] if R.ndim == 1 else R).expand(b, n)
    return LGSSM(A=A.reshape(b * n, d, d).to(dtype), Q=Q.reshape(b * n, d, d).to(dtype),
                 H=block.H.to(dtype), R=R.reshape(b * n).to(dtype), e1=True)
