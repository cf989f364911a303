from gpar_at_scale_torch.inference.optimize import (
    OptResult,
    minimize_adam,
    minimize_lbfgs,
    multi_start,
)

__all__ = ["OptResult", "minimize_adam", "minimize_lbfgs", "multi_start"]
