from gpar_at_scale_torch.utils.params import (
    constrain,
    init_params,
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

# The JAX package's init_gp_params, init_gpar_params and init_gpar_params6
# are ``init_params(3 | 5 | 6, generator, dtype, device)`` here.
__all__ = [
    "constrain", "unconstrain", "unpack_gp", "unpack_gpar", "unpack_gpar6",
    "pack_gp", "pack_gpar", "pack_gpar6", "init_params",
    "add_jitter", "cho_solve", "cholesky_psd", "logdet_from_chol", "solve_lower", "solve_upper",
]

from gpar_at_scale_torch.utils.checkpoint import (  # noqa: E402
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from gpar_at_scale_torch.utils.observability import (  # noqa: E402
    MetricsLogger,
    profiler_trace,
    stage_timer,
)
from gpar_at_scale_torch.utils.resilience import run_with_checkpointing  # noqa: E402

__all__ += [
    "latest_step", "restore_checkpoint", "save_checkpoint",
    "MetricsLogger", "profiler_trace", "stage_timer",
    "run_with_checkpointing",
]
