from gpar_at_scale_torch.gp import exact
from gpar_at_scale_torch.gp.dtc import QU, compute_q_u, dtc_objective, predict_scaled

__all__ = ["QU", "compute_q_u", "dtc_objective", "exact", "predict_scaled"]
