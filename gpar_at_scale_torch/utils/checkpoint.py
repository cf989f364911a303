"""Checkpoint and resume of a tree of tensors.

Counterpart of ``gpar_at_scale_tpu/utils/checkpoint.py``, with the same
layout: one directory ``step_%010d`` per checkpoint under ``directory``,
written into ``step_%010d.tmp`` and renamed into place, so a crash leaves no
half-written checkpoint behind.  The tree (dicts, lists, tuples and named
tuples of tensors and numbers) is one ``torch.save`` file read back with
``torch.load(weights_only=True)``.  Under ``torch.distributed`` only rank 0
writes, and every process can read.  A failed save raises: there is no
second format to fall back on.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

_FILE = "tree.pt"


def _is_rank_zero() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _plain(tree):
    """Named tuples as plain tuples (``weights_only`` loads no classes);
    ``restore_checkpoint(like=)`` puts the structure back."""
    if torch.is_tensor(tree):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_plain(v) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    return tree


def _like(tree, like):
    """``tree`` in the containers of ``like``, its tensors moved to the
    devices and dtypes of ``like``'s tensors."""
    if torch.is_tensor(like):
        return torch.as_tensor(tree).to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        return {k: _like(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_like(a, b) for a, b in zip(tree, like)]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    return tree


def save_checkpoint(directory: str, step: int, tree: Any, overwrite: bool = True) -> str:
    """Save ``tree`` at ``directory/step_<step>`` (rank 0 only); returns
    the path.  An existing checkpoint of that step is replaced when
    ``overwrite``, else ``FileExistsError`` is raised."""
    path = _path(directory, step)
    if not _is_rank_zero():
        return path
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(_plain(tree), os.path.join(tmp, _FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def restore_checkpoint(directory: str, step: Optional[int] = None, like: Any = None) -> Any:
    """The tree saved at ``step`` (default: the latest), its tensors on the
    devices they were saved from.  ``like``, an example tree, gives back its
    named tuples and its tensors' devices and dtypes."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    tree = torch.load(os.path.join(_path(directory, step), _FILE), weights_only=True)
    return tree if like is None else _like(tree, like)


def latest_step(directory: str) -> Optional[int]:
    """The highest step with a complete checkpoint in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name[len("step_"):])
        for name in os.listdir(directory)
        if name.startswith("step_") and not name.endswith(".tmp")
    ]
    return max(steps) if steps else None
