from gpar_at_scale_torch.ssm.blocked import (
    blocked_affine_suffix_scan,
    blocked_filter,
    blocked_posterior_sample,
    blocked_smooth,
    blocked_suffix_scan,
    ffbs_draw,
)
from gpar_at_scale_torch.ssm.kalman import (
    decorrelate,
    kalman_filter,
    logpdf,
    posterior_sample,
    rts_smooth,
)
from gpar_at_scale_torch.ssm.markov import LGSSM, SDE, discretize, lgssm_of, to_sde
from gpar_at_scale_torch.ssm.segmented import (
    segmented_decorrelate,
    segmented_filter,
    segmented_logpdf,
    segmented_posterior_sample,
    segmented_smooth,
)

__all__ = [
    "LGSSM", "SDE", "discretize", "lgssm_of", "to_sde",
    "decorrelate", "kalman_filter", "logpdf", "posterior_sample", "rts_smooth",
    "blocked_affine_suffix_scan", "blocked_filter", "blocked_posterior_sample", "blocked_smooth",
    "blocked_suffix_scan", "ffbs_draw",
    "segmented_decorrelate", "segmented_filter", "segmented_logpdf", "segmented_posterior_sample",
    "segmented_smooth",
]
