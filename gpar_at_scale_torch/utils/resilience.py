"""Checkpointed step loops with resume.

Counterpart of ``gpar_at_scale_tpu/utils/resilience.py``: a step loop that
checkpoints every k steps and, started again after a crash, resumes from the
latest checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from gpar_at_scale_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from gpar_at_scale_torch.utils.observability import MetricsLogger, synchronize


def run_with_checkpointing(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    num_steps: int,
    checkpoint_dir: Optional[str] = None,
    *,
    checkpoint_every: int = 100,
    logger: Optional[MetricsLogger] = None,
) -> Tuple[Any, int]:
    """Run ``state = step_fn(state, step)`` up to ``num_steps``, saving the
    state every ``checkpoint_every`` steps and at the end, and resuming
    from the latest checkpoint in ``checkpoint_dir`` if there is one
    (restored in the structure, devices and dtypes of ``init_state``).
    Each save waits for the device work the state depends on.  Returns
    (final state, steps run by this process)."""
    start = 0
    state = init_state
    if checkpoint_dir:
        last = latest_step(checkpoint_dir)
        if last is not None:
            state = restore_checkpoint(checkpoint_dir, step=last, like=init_state)
            start = last
            if logger:
                logger.record("resume", step=last)

    ran = 0
    for step in range(start, num_steps):
        state = step_fn(state, step)
        ran += 1
        if checkpoint_dir and (step + 1) % checkpoint_every == 0:
            synchronize(state)
            save_checkpoint(checkpoint_dir, step + 1, state)
            if logger:
                logger.record("checkpoint", step=step + 1)
    if checkpoint_dir and num_steps > start:
        synchronize(state)
        save_checkpoint(checkpoint_dir, num_steps, state)
    return state, ran
