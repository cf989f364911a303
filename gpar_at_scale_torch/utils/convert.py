"""Carry a fitted chain's weights across from the JAX package.

Both functions take numpy arrays only (``numpy.asarray`` of the JAX
arrays), so this module needs neither JAX nor the JAX package.  The
log-parameter vectors mean the same in both packages (the ``exp(p) + 1e-3``
transform of ``utils/params.py``), so they carry over unchanged.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from gpar_at_scale_torch.device import resolve_device
from gpar_at_scale_torch.gp.dtc import QU


def _tensor(a, device, dtype):
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array, got {type(a).__name__}")
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def params_from_numpy(arrays: Sequence[np.ndarray], device=None, dtype=torch.float64) -> List[torch.Tensor]:
    """The chain's raw log-parameter vectors ((3,) for output 1, (5,) or
    (6,) for each conditional) as tensors on ``device``, ready for
    ``fit_gpar(..., init_params=...)``."""
    device = resolve_device(device)
    out = []
    for i, a in enumerate(arrays):
        p = _tensor(a, device, dtype)
        want = (3,) if i == 0 else ((5,), (6,))
        if (i == 0 and p.shape != want) or (i > 0 and p.shape not in want):
            raise ValueError(f"output {i + 1}: unexpected log-parameter shape {tuple(p.shape)}")
        out.append(p)
    return out


def qu_from_numpy(m_eps, L_D, L_uu, Z, device=None, dtype=torch.float64) -> QU:
    """A JAX ``QU`` (its four fields as numpy arrays) as the port's ``QU``,
    so that ``predict`` can be held against the JAX package alone."""
    device = resolve_device(device)
    m_eps, L_D, L_uu, Z = (_tensor(a, device, dtype) for a in (m_eps, L_D, L_uu, Z))
    M = m_eps.shape[0]
    if L_D.shape != (M, M) or L_uu.shape != (M, M) or Z.shape[0] != M:
        raise ValueError(
            f"inconsistent q(u) shapes: m_eps {tuple(m_eps.shape)}, L_D {tuple(L_D.shape)}, "
            f"L_uu {tuple(L_uu.shape)}, Z {tuple(Z.shape)}"
        )
    return QU(m_eps=m_eps, L_D=L_D, L_uu=L_uu, Z=Z if Z.ndim == 2 else Z[:, None])
