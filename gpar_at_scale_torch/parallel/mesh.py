"""Named meshes of ranks and the placement of arrays on them.

Counterpart of ``gpar_at_scale_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions over the
ranks of the default process group; each named axis has its own process
group (``axis_group``).  Conventions, as in the JAX package:

  axis "chain" -- independent work: optimizer chains, GPAR conditionals;
  axis "data"  -- the time axis of the series (``parallel/seqshard.py``);
  axis "model" -- the M pseudo-points (``parallel/modelshard.py``).

Placement is by rank: ``shard_along`` gives a rank its slice of a
dimension (uneven by at most one row when the axis does not divide it),
``replicated`` leaves every rank the whole array.  There is no global
array: each rank holds what it computes on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _ensure_process_group():
    """A one-rank gloo group in this process when none exists, so that a
    world-1 mesh needs no launcher."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(axis_names: Sequence[str] = ("chain", "data"),
              axis_sizes: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over every rank with the named axes.  With
    ``axis_sizes=None`` every rank goes to the first axis; sizes whose
    product is not the world size raise ``ValueError``.  The mesh's device
    type is ``cuda`` on NCCL and ``cpu`` on gloo (whose ranks may still
    compute on a card: ``parallel/distributed.py``)."""
    from torch.distributed.device_mesh import init_device_mesh

    _ensure_process_group()
    n = dist.get_world_size()
    names = tuple(axis_names)
    sizes = [n] + [1] * (len(names) - 1) if axis_sizes is None else [int(s) for s in axis_sizes]
    if len(sizes) != len(names):
        raise ValueError(f"{len(names)} axis names for {len(sizes)} sizes")
    prod = 1
    for s in sizes:
        prod *= s
    if prod != n:
        raise ValueError(f"axis sizes {sizes} do not multiply to {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of the ranks that share every coordinate but
    ``axis`` with this one; None for an axis of size 1 (no communication)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def spans(n: int, parts: int) -> List[Tuple[int, int]]:
    """[(start, length)] of ``parts`` contiguous slices of n rows, the
    first n % parts one row longer.  Raises when a slice would be empty."""
    if n < parts:
        raise ValueError(f"{n} rows cannot give each of {parts} ranks a row")
    base, extra = divmod(n, parts)
    out, start = [], 0
    for r in range(parts):
        ln = base + (1 if r < extra else 0)
        out.append((start, ln))
        start += ln
    return out


def shard_along(mesh, axis_name: Optional[str], x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of dimension ``dim`` of x over mesh axis
    ``axis_name`` (``spans``); None, or an axis of size 1, keeps all of x."""
    if axis_name is None or axis_size(mesh, axis_name) == 1:
        return x
    start, ln = spans(x.shape[dim], axis_size(mesh, axis_name))[axis_rank(mesh, axis_name)]
    return x.narrow(dim, start, ln)


def replicated(mesh, x: torch.Tensor) -> torch.Tensor:
    """x as every rank of the mesh holds it: the whole array."""
    del mesh
    return x
