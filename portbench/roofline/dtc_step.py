"""Operations of the DTC conditional's training step and of its q(u).

The algorithm's work at n time steps, M pseudo-points over D inputs, a
state of dimension d and B = M + 1 whitened columns [y | K_fu]:

* K_fu: per entry 3 D for the scaled squared distance and 8 for the
  Matern-5/2 (sqrt, scale, polynomial, exp, products); its cotangent twice
  that;
* the whitening filter: the gain pass (K1, K2's operations) and the column
  sweep with its means (K3's), per step;
* the Gram W'W, 2 n B^2, and its cotangent 2 W dG, 2 n B^2;
* the backward adjoint over the B columns (K4a, K4b's operations).

The M x M algebra (O(M^3)) and the discretization's O(n d^3) elementwise
work are left out: a lower count, so a share of a peak is not overstated.
"""

from __future__ import annotations

from portbench.roofline import scan


def kernel_entry_flops(D):
    return 3 * D + 8


def forward_flops(n, M, D, d=3):
    B = M + 1
    return (n * M * kernel_entry_flops(D) + n * (scan.k1_flops(d) + scan.k2_flops(d))
            + n * scan.k3_flops(d, B) + 2 * n * B * B)


def step_flops(n, M, D, d=3):
    """Value and gradient of the bound: one Adam step."""
    B = M + 1
    backward = (2 * n * B * B + n * (scan.k4a_flops(d, B) + scan.k4b_flops(d, B))
                + 2 * n * M * kernel_entry_flops(D))
    return forward_flops(n, M, D, d) + backward


def qu_flops(n, M, D, d=3):
    """q(u) at the optimum: the forward alone."""
    return forward_flops(n, M, D, d)
