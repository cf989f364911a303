from gpar_at_scale_torch.models.gpar import (
    FittedConditional,
    FittedGP,
    FittedGPAR,
    GPARConfig,
    fit_conditional,
    fit_conditionals_parallel,
    fit_first_output,
    fit_gpar,
)

__all__ = [
    "FittedConditional",
    "FittedGP",
    "FittedGPAR",
    "GPARConfig",
    "fit_conditional",
    "fit_conditionals_parallel",
    "fit_first_output",
    "fit_gpar",
]
