from gpar_at_scale_torch.models.bayes import (
    BayesConditionalResult,
    bounded_reparam,
    make_conditional_logpost,
    make_temporal_logpost,
    predictive_mixture_scaled,
    sample_conditional_posterior,
)
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
    "BayesConditionalResult",
    "bounded_reparam",
    "make_conditional_logpost",
    "make_temporal_logpost",
    "predictive_mixture_scaled",
    "sample_conditional_posterior",
    "FittedConditional",
    "FittedGP",
    "FittedGPAR",
    "GPARConfig",
    "fit_conditional",
    "fit_conditionals_parallel",
    "fit_first_output",
    "fit_gpar",
]
