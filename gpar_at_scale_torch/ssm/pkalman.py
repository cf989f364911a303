"""Filtering elements of the parallel Kalman filter (Sarkka &
Garcia-Fernandez, arXiv:1905.13002).

Counterpart of the element algebra of ``gpar_at_scale_tpu/ssm/pkalman.py``:
``_filter_elements`` builds the per-step elements that the blocked engine
(``ssm/blocked.py``) and the CUDA scan kernels' plain versions fold, and
``_combine`` is the solve-based combine that ``ssm.blocked._combine_fast``
(adjugate inverse) reproduces.  The associative-scan engines themselves
(``parallel_filter``, ``parallel_smooth``) are still to be ported (ROADMAP
P8).

Element per step k (A_0 = 0, Q_0 = Pinf, so the prior enters at step 0):

    S_k = H Q_k H^T + R_k          K_k = Q_k H^T / S_k
    A'_k = (I - K_k H) A_k         b'_k = K_k y_k
    C'_k = (I - K_k H) Q_k
    eta'_k = A_k^T H^T y_k / S_k   J'_k = A_k^T H^T H A_k / S_k

b and eta carry a trailing column axis B; A, C, J are shared.
"""

from __future__ import annotations

import torch

from gpar_at_scale_torch.ssm.markov import LGSSM


def _filter_elements(lgssm: LGSSM, Y):
    """Per-step scan elements for Y (N, B)."""
    A, Q, H, R = lgssm.A, lgssm.Q, lgssm.H, lgssm.R
    d = lgssm.dim
    I = torch.eye(d, dtype=A.dtype, device=A.device)
    S = torch.einsum("i,nij,j->n", H, Q, H) + R
    K = torch.einsum("nij,j->ni", Q, H) / S[:, None]
    ImKH = I - K[:, :, None] * H[None, None, :]
    A_el = ImKH @ A
    b_el = K[:, :, None] * Y[:, None, :]
    C_el = ImKH @ Q
    HA = torch.einsum("a,nab->nb", H, A)
    eta_el = HA[:, :, None] * (Y / S[:, None])[:, None, :]
    J_el = HA[:, :, None] * HA[:, None, :] / S[:, None, None]
    return A_el, b_el, C_el, eta_el, J_el


def _combine(elem_i, elem_j):
    """Associative combine of filtering elements (i earlier, j later), with
    general (..., d, d) solves (``solve_ex``: no host sync for an error
    check; Z and Z2 have eigenvalues >= 1 since C and J are PSD)."""
    A_i, b_i, C_i, eta_i, J_i = elem_i
    A_j, b_j, C_j, eta_j, J_j = elem_j
    d = A_i.shape[-1]
    I = torch.eye(d, dtype=A_i.dtype, device=A_i.device)
    Z = I + C_i @ J_j
    AjZ = torch.linalg.solve_ex(Z.transpose(-1, -2), A_j.transpose(-1, -2))[0].transpose(-1, -2)
    A_ij = AjZ @ A_i
    b_ij = AjZ @ (b_i + C_i @ eta_j) + b_j
    C_ij = AjZ @ C_i @ A_j.transpose(-1, -2) + C_j
    Z2 = I + J_j @ C_i
    AiTZ2 = torch.linalg.solve_ex(Z2.transpose(-1, -2), A_i)[0].transpose(-1, -2)
    eta_ij = AiTZ2 @ (eta_j - J_j @ b_i) + eta_i
    J_ij = AiTZ2 @ J_j @ A_i + J_i
    return A_ij, b_ij, C_ij, eta_ij, J_ij
