from gpar_at_scale_torch.inference.diagnostics import (
    Diagnostics,
    ess,
    means_agree_within_mc_error,
    split_rhat,
    summarize,
)
from gpar_at_scale_torch.inference.hmc import effective_sample_size, hmc, value_and_grad
from gpar_at_scale_torch.inference.nuts import nuts
from gpar_at_scale_torch.inference.optimize import (
    AdamState,
    OptResult,
    adam_init,
    adam_update,
    minimize_adam,
    minimize_lbfgs,
    multi_start,
)
from gpar_at_scale_torch.inference.smc import smc, smc_host
from gpar_at_scale_torch.inference.vi import fit_sparse_vi, predict_sparse_vi

__all__ = [
    "AdamState", "OptResult", "adam_init", "adam_update", "minimize_adam", "minimize_lbfgs", "multi_start",
    "Diagnostics", "ess", "means_agree_within_mc_error", "split_rhat", "summarize",
    "effective_sample_size", "hmc", "value_and_grad", "nuts", "smc", "smc_host",
    "fit_sparse_vi", "predict_sparse_vi",
]
