"""Device and precision policy of the PyTorch port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request they raise instead of quietly
running on the host.

Importing this module turns reduced-precision matmuls off, the counterpart of
``jax.default_matmul_precision("highest")`` in the JAX package: TF32 keeps
about three decimal digits, which makes kernel Gram matrices lose PSD-ness
and makes the discretized process noise ``Q = Pinf - A Pinf A^T`` indefinite
(the numerics rules in ``CLAUDE.md``).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev
