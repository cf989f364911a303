from gpar_at_scale_torch.utils.params import (
    constrain,
    pack_gp,
    pack_gpar,
    pack_gpar6,
    unconstrain,
    unpack_gp,
    unpack_gpar,
    unpack_gpar6,
)
from gpar_at_scale_torch.utils.psd import (
    add_jitter,
    cho_solve,
    cholesky_psd,
    logdet_from_chol,
    solve_lower,
    solve_upper,
)

__all__ = [
    "constrain", "unconstrain", "unpack_gp", "unpack_gpar", "unpack_gpar6",
    "pack_gp", "pack_gpar", "pack_gpar6",
    "add_jitter", "cho_solve", "cholesky_psd", "logdet_from_chol", "solve_lower", "solve_upper",
]
