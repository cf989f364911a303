"""Process-group start-up and the collectives of the parallel layer.

Counterpart of ``gpar_at_scale_tpu/parallel/distributed.py``.  One process
per rank, started by a launcher (``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or
given its address, world size and rank.  The backend is NCCL when every
rank of a host has a card of its own, else gloo: gloo runs the CPU tests,
and two ranks that share one card (NCCL refuses that) run over gloo with
their tensors on the card.

The collectives here are the only ones the parallel layer calls:
``all_gather`` (equal shapes), ``all_gather_rows`` (uneven leading
dimension, padded to the longest), ``all_reduce_sum`` and
``all_gather_object``.  Gloo has no collective for CUDA tensors but
broadcast and all_reduce, so on a gloo group every collective of CUDA
tensors is staged through the host explicitly: a copy to the CPU, the
collective, a copy back.  The kernels still run on the card.  A group of
one rank communicates nothing: every helper returns its input.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Start the default process group when running under a launcher or
    when given an address; returns True if more than one process is in it.

    ``coordinator_address``: a ``torch.distributed`` init URL
    (``tcp://host:port`` or ``file:///path``; a bare ``host:port`` means
    tcp), with ``num_processes`` and ``process_id``.  Without it the
    launcher's environment is read (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); without either it does nothing and
    returns False.  ``backend``: None picks NCCL when CUDA is present with
    a card per local rank, else gloo.  With CUDA the process's device is
    ``LOCAL_RANK`` (modulo the cards present).  A second call is safe: it
    reports the group that exists."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "RANK" not in env:
        return False
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    else:
        url, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if cuda and torch.cuda.device_count() >= local_world else "gloo"
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    return world > 1


def global_mesh(axis_names: Sequence[str] = ("chain", "data"),
                axis_sizes: Optional[Sequence[int]] = None):
    """Mesh over every rank of the default process group
    (``parallel.mesh.make_mesh``); the last axis takes consecutive ranks,
    which a launcher places on one host, so the data and model axes, which
    carry the scans' carries and the Gram, stay inside a host."""
    from gpar_at_scale_torch.parallel.mesh import make_mesh

    return make_mesh(axis_names, axis_sizes)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(x, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """x from every rank of ``group``, in rank order (equal shapes)."""
    if group_size(group) == 1:
        return [x]
    staged = _staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    out = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(x.device) for o in out] if staged else out


def all_gather_rows(x: torch.Tensor, counts: Sequence[int], group) -> torch.Tensor:
    """Concatenate along dim 0 the rows of every rank (rank r holds
    counts[r] rows): padded to the longest, gathered, cut."""
    if group_size(group) == 1:
        return x
    most = max(counts)
    pad = most - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    parts = all_gather(x, group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of ``group`` (a new tensor)."""
    if group_size(group) == 1:
        return x
    staged = _staged(x, group)
    buf = x.detach().cpu().clone() if staged else x.detach().clone().contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device) if staged else buf


def all_gather_object(obj, group) -> list:
    """A picklable object from every rank of ``group``, in rank order."""
    if group_size(group) == 1:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ct, ctx.group), None


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged, with its cotangent summed over ``group`` on the way
    back.  Every rank holds the same x and feeds it into its own share of a
    sharded computation: the sum of the shares' cotangents is x's whole
    cotangent from that computation.  A tensor that needs no grad, or a
    group of one rank, passes through."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumGrads.apply(x, group)
