"""Several processes, one per host (counterpart of
``lungmask_tpu.parallel.multihost``), on ``torch.distributed``.

Every process runs the same program over its own devices (its mesh, see
``parallel/mesh.py``). :func:`initialize_multihost` joins the processes into
one group — NCCL where CUDA is available, gloo on the CPU — after which the
sharded train step (``train/trainer.py``) sums its loss terms and gradients
over the group; :func:`shard_cohort` gives each process its part of a
cohort's volumes.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from lungmask_tpu_torch.logger import logger


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    """The rendezvous as an ``init_method`` URL: the argument, else
    ``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``, else
    ``MASTER_ADDR`` and ``MASTER_PORT``; ``host:port`` becomes
    ``tcp://host:port``, a URL (``tcp://``, ``file://``) is kept."""
    addr = (coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS"))
    if not addr and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if addr and "://" not in addr:
        addr = "tcp://" + addr
    return addr or None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join this process to the group of ``num_processes`` (default
    ``$WORLD_SIZE``) as rank ``process_id`` (default ``$RANK``), meeting at
    ``coordinator_address`` (see :func:`_address`). True once a group
    exists. Single-host (no address, and at most one process) it does
    nothing and returns False, so it is safe to call unconditionally; a
    group that was asked for and cannot form raises."""
    if dist.is_available() and dist.is_initialized():
        return True
    addr = _address(coordinator_address)
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if addr is None and world in (None, 1):
        return False
    if addr is None or world is None:
        raise ValueError(
            "a multi-process group needs a coordinator address and a process count "
            "(arguments, or MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)"
        )
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("a multi-process group needs this process's rank (process_id or $RANK)")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank)
    logger.info(f"multihost initialized ({backend}): process {rank}/{world}")
    return True


def shard_cohort(sources: Sequence, process_id: Optional[int] = None,
                 process_count: Optional[int] = None) -> list:
    """This process's part of a cohort's volume list, round-robin by rank
    (the group's rank and size unless given; 0 of 1 without a group):
    deterministic given the same order, disjoint, complete."""
    grouped = dist.is_available() and dist.is_initialized()
    if process_id is None:
        process_id = dist.get_rank() if grouped else 0
    if process_count is None:
        process_count = dist.get_world_size() if grouped else 1
    return [s for i, s in enumerate(sources) if i % process_count == process_id]
