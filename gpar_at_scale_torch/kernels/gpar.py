"""The GPAR additive kernel.  Counterpart of
``gpar_at_scale_tpu/kernels/gpar.py``.

For output i with inputs ``(t, y_1..y_{i-1})``::

    k((t, y), (t', y')) = s_t k_time(t / l_t, t' / l_t) + s_o k_out(y / l_o, y' / l_o)

with the time block on column 0 and the output block on columns 1..D-1.
"""

from __future__ import annotations

from gpar_at_scale_torch.kernels.base import Sum


def gpar_kernel(time_family, out_family, input_dim: int, time_l, time_sigma, out_l, out_sigma):
    """Additive masked GPAR kernel over (time, previous-output) features;
    variances are sigma^2."""
    if input_dim < 2:
        raise ValueError("gpar_kernel needs >= 2 input dims (time + >=1 output)")
    time_k = time_family(lengthscale=time_l, variance=time_sigma**2).select((0,))
    out_k = out_family(lengthscale=out_l, variance=out_sigma**2).select(
        tuple(range(1, input_dim))
    )
    return Sum(time_k, out_k)


def time_kernel_only(time_family, time_l, time_sigma):
    """First output of the chain: a plain scaled kernel on time."""
    return time_family(lengthscale=time_l, variance=time_sigma**2)
