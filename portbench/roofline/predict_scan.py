"""Operations of one long-series predictive request: b hyperparameter draws
against one q(u) (b = 1 for ``predict_scaled``), n training and n* held-out
times spliced into n_all = n + n* steps, M pseudo-points over D inputs, a
time GP of state dimension d, C = M + 1 smoothed columns [y - fx | G].

Counted per draw: K_*u (3 D + 8 per entry, as ``dtc_step``), the products
with q(u)'s inverse factors Phi = K_*u W_uu and G = Phi W_D (2 n_all M^2
each) and fx = Phi m (2 n_all M); the smoother over the C columns: the
filter's gain pass and column sweep (K1, K2, K3's operations a step), the
per-column smoothing elements g = m - E (A' m) (4 d^2 C a step) and the
suffix scan (K4a, K4b's); the moments at the held-out rows (2 n* M).  The
discretization and the elements' shared 3 x 3 algebra (O(n d^3)) are left
out: a lower count, so a share of a peak is not overstated.  The same
counts hold whatever implements the smoother (the kernels or the
tensor-code blocked smoother of ``predict_scaled``).
"""

from __future__ import annotations

from portbench.roofline import scan
from portbench.roofline.dtc_step import kernel_entry_flops


def request_flops(b, n, n_star, M, D, d=3):
    n_all, C = n + n_star, M + 1
    products = n_all * M * kernel_entry_flops(D) + 4 * n_all * M * M + 2 * n_all * M
    smoother = n_all * (scan.k1_flops(d) + scan.k2_flops(d) + scan.k3_flops(d, C) + 4 * d * d * C
                        + scan.k4a_flops(d, C) + scan.k4b_flops(d, C))
    return b * (products + smoother + 2 * n_star * M)
