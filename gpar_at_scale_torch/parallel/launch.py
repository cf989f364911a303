"""Run one function on n ranks of this host, each in a process of its own.

``run_ranks(fn, world_size, *args, init_file=...)`` spawns ``world_size``
processes (the ``spawn`` start method: a parent with threads must not
fork), joins them into one process group through ``init_file`` (a
``file://`` store, so that runs side by side need no free port), calls
``fn(*args)`` on each and returns their results in rank order.  ``fn`` and
its arguments are pickled, so ``fn`` is a module-level function; its result
should be numpy arrays or numbers.  The children never build kernels:
build them in the parent first (``ops.build.build_all``), so that two ranks
do not compile into ``build/`` at once.

``run_world(fn, world_size, *args)`` is the drivers' form: one rank runs in
this process (NCCL on a card, gloo on the host), more are spawned; the
stores go under ``build/ranks/`` at the repository root.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional

STORE_DIR = Path(__file__).resolve().parents[2] / "build" / "ranks"


def _rank_main(fn, rank, world_size, init_file, backend, threads, args, results):
    import torch
    import torch.distributed as dist

    from gpar_at_scale_torch.parallel.distributed import initialize_distributed

    try:
        if threads:
            torch.set_num_threads(threads)
        initialize_distributed(f"file://{init_file}", world_size, rank, backend=backend)
        results.put((rank, True, fn(*args)))
    except BaseException:  # the parent re-raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args, init_file: str,
              backend: Optional[str] = None, threads: int = 0,
              timeout: float = 600.0) -> List[Any]:
    """``[fn(*args) on rank r for r in range(world_size)]``, each rank a
    spawned process in one group (``backend``: None lets
    ``initialize_distributed`` choose).  ``threads`` > 0 caps each rank's
    torch threads.  Raises ``RuntimeError`` with a rank's traceback if any
    rank fails, and on ``timeout`` seconds without a result."""
    if os.path.exists(init_file):
        os.remove(init_file)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, init_file, backend, threads, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world_size):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"run_ranks: no result within {timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5.0 if errors or len(out) < world_size else 60.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
    if errors:
        raise RuntimeError("run_ranks failed on " + "\n".join(errors))
    return [out[r] for r in range(world_size)]


def rank_device(kind: str):
    """The device a rank of ``run_world`` computes on: its card for
    ``kind`` "cuda" (``initialize_distributed`` has set it), else the host."""
    import torch

    return torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else torch.device("cpu")


def run_world(fn: Callable, world_size: int, *args, name: str = "world",
              timeout: float = 900.0) -> List[Any]:
    """``[fn(*args) on rank r]`` over ``world_size`` ranks of this host:
    one rank in this process, in a group of its own that is destroyed
    after (or in the group that exists), more through ``run_ranks``.  The
    backend is ``initialize_distributed``'s choice: NCCL when every rank
    has a card of its own, else gloo (two ranks that share one card).  The
    kernels are built here first, so that the ranks only load them; each
    spawned rank takes its share of this host's cores for its threads."""
    import torch
    import torch.distributed as dist

    from gpar_at_scale_torch.parallel.distributed import initialize_distributed

    STORE_DIR.mkdir(parents=True, exist_ok=True)
    store = STORE_DIR / f"{name}-{os.getpid()}"
    if torch.cuda.is_available():
        from gpar_at_scale_torch.ops.build import build_all

        build_all()
    if world_size > 1:
        return run_ranks(fn, world_size, *args, init_file=str(store), timeout=timeout,
                         threads=max(1, (os.cpu_count() or 1) // world_size))
    if dist.is_initialized():
        return [fn(*args)]
    if store.exists():
        store.unlink()
    initialize_distributed(f"file://{store}", 1, 0)
    try:
        return [fn(*args)]
    finally:
        dist.destroy_process_group()
