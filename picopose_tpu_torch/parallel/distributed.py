"""Process groups: bring-up, rank info, host broadcast and barrier.

Counterpart of picopose_tpu/parallel/distributed.py:23-82 on
``torch.distributed``.  The JAX package runs one program over the devices
of every host; here each rank is a process that drives one device, and
the ranks meet in a process group:

  * ``initialize()`` with no arguments reads the variables ``torchrun``
    sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR; MASTER_PORT too) and
    joins their group; without them it is a single-process no-op.  Keyword
    arguments (``init_method=``, ``world_size=``, ``rank=``) go to
    ``init_process_group`` unchanged and its errors propagate;
  * the backend is the caller's: ``nccl`` (the default) for ranks on
    distinct cards, ``gloo`` for ranks on the CPU or ranks that share a
    card.  Nothing here chooses between them;
  * ``broadcast_host_data`` sends rank 0's Python object to every rank;
  * ``all_hosts_barrier`` waits for every rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def is_initialized() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def torchrun_env() -> dict[str, str] | None:
    """The variables a ``torchrun`` launch sets, or None when any is missing."""
    env = {k: os.environ.get(k) for k in TORCHRUN_ENV}
    return None if None in env.values() else env


def initialize(backend: str = "nccl", **kwargs) -> None:
    """Join the process group (see the module docstring).  With the
    ``nccl`` backend under ``torchrun`` the rank's card is
    ``cuda:LOCAL_RANK``; a rank whose card does not exist raises."""
    if is_initialized():
        return
    if kwargs:
        dist.init_process_group(backend=backend, **kwargs)
        return
    env = torchrun_env()
    if env is None:
        return
    extra = {}
    if backend == "nccl":
        local = int(env["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} but this host has {torch.cuda.device_count()} CUDA devices: "
                "launch at most one nccl rank per card (gloo lets ranks share one)"
            )
        extra["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend=backend, init_method="env://", **extra)


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def backend() -> str | None:
    """The process group's backend, or None outside one."""
    return dist.get_backend() if is_initialized() else None


def broadcast_host_data(tree):
    """Rank 0's ``tree`` (any picklable object) on every rank."""
    if process_info()[1] == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_hosts_barrier(name: str = "barrier") -> None:
    """Wait until every rank has reached this call (``name`` labels it
    for a reader; torch barriers are anonymous)."""
    if process_info()[1] > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if is_initialized():
        dist.destroy_process_group()
