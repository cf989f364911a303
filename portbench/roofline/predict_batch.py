"""Operations of one batched predictive (gp/dtc.py::predict_scaled_batch):
b hyperparameter draws on one q(u), n training and n* test times, M
pseudo-points over D inputs, n_all = n + n*.

Counted: the factorizations (Cholesky, n^3 / 3), the triangular solves
(n^2 per right-hand side), the products (2 m n k) and the kernel
matrices (3 D + 8 per entry, as ``dtc_step``).  These are what the least
time of the batch is made of; they are float32 on CUDA cores (TF32 off).
"""

from __future__ import annotations

from portbench.roofline.dtc_step import kernel_entry_flops


def batch_flops(b, n, n_star, M, D):
    n_all = n + n_star
    k_su = n_all * M * kernel_entry_flops(D)  # K_*u
    shared_solves = 2 * M * M * n_all  # K_*u L_uu^-T, then L_D^-T
    fbar = 2 * n_all * M
    k_time = n_all * n_all * kernel_entry_flops(1)
    chol = n_all**3 / 3
    solve = n_all * n_all * (n_all + M + 1)  # L^-1 [K | G | y - fbar]
    mean = 2 * n_all * n_all * (M + 1)  # W' W_b
    var = 2 * n_all * n_all + 2 * n_all * M
    return b * (k_su + shared_solves + fbar + k_time + chol + solve + mean + var)
