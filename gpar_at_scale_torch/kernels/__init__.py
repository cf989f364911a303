from gpar_at_scale_torch.kernels.base import (
    Kernel,
    LinearMapKernel,
    Product,
    ScaledKernel,
    SelectDims,
    Sum,
    sq_dist,
)
from gpar_at_scale_torch.kernels.gpar import gpar_kernel, time_kernel_only
from gpar_at_scale_torch.kernels.stationary import EQ, RQ, Matern12, Matern32, Matern52, scaled

__all__ = [
    "Kernel",
    "Sum",
    "Product",
    "ScaledKernel",
    "SelectDims",
    "LinearMapKernel",
    "sq_dist",
    "EQ",
    "Matern12",
    "Matern32",
    "Matern52",
    "RQ",
    "gpar_kernel",
    "time_kernel_only",
    "scaled",
]
