from gpar_at_scale_torch.ssm.blocked import blocked_filter, blocked_smooth, blocked_suffix_scan
from gpar_at_scale_torch.ssm.kalman import decorrelate, kalman_filter, logpdf, rts_smooth
from gpar_at_scale_torch.ssm.markov import LGSSM, SDE, discretize, lgssm_of, to_sde

__all__ = [
    "LGSSM", "SDE", "discretize", "lgssm_of", "to_sde",
    "decorrelate", "kalman_filter", "logpdf", "rts_smooth",
    "blocked_filter", "blocked_smooth", "blocked_suffix_scan",
]
