"""Data parallelism over ``torch.distributed`` (port of ``trcnn/parallel``).

The JAX package scales out over a (data, model) device mesh: batch arrays
shard over ``data``, parameters replicate, and XLA inserts the gradient
all-reduce from the shardings.  The port runs one process per device in a
``torch.distributed`` group:

  * :func:`initialize` -- ``init_process_group`` with the arguments of
    ``jax.distributed.initialize``; with none of them, the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``, as ``torchrun`` sets them), the counterpart of the TPU
    metadata auto-detect.  It selects the rank's device and returns it.
  * :func:`is_main_process`, :func:`world_size`, :func:`rank`: the process
    that logs and writes checkpoints; 1 and 0 when no group exists.
  * :func:`all_reduce_sum_`, :func:`broadcast_`: in-place collectives over
    a list of tensors, flattened into one buffer per dtype (the gradient
    sum of the data-parallel step, the replicas' parameters at creation).
  * :func:`host_gather`: every rank's Python object, in rank order, over a
    gloo group (the evaluator's detections), beside an NCCL group if the
    group is one.

The mesh's ``model`` axis (fc6/fc7 tensor parallelism) is not ported: every
parameter is replicated.  A ``group`` argument of None means one process
with no collective at all.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_main_process", "world_size", "rank"]

# gloo groups beside an NCCL group, for gathers of host objects
_host_groups: Dict[Any, Any] = {}


def _device(backend: str, local_device_ids: Optional[Sequence[int]], rank_: int) -> torch.device:
    """The rank's device: ``local_device_ids[0]`` if given; for NCCL the
    ``LOCAL_RANK`` card (else the rank's, modulo the cards); else the CPU."""
    if local_device_ids is not None:
        return torch.device("cuda", int(local_device_ids[0]))
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else rank_ % torch.cuda.device_count()
        return torch.device("cuda", index)
    return torch.device("cpu")


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator_address``: "host:port" of rank 0 (a TCP rendezvous), or a
    URL that ``init_process_group`` takes (``tcp://``, ``file://``);
    ``num_processes`` and ``process_id``: the world size and this rank,
    from ``WORLD_SIZE`` and ``RANK`` when None.  With all three None the
    environment gives the address too (``env://``).
    ``local_device_ids``: the card this process drives (e.g. ``[0]`` for
    several ranks sharing one card, over gloo); by default the
    ``LOCAL_RANK`` card under NCCL, the CPU under gloo.  ``backend``:
    "nccl" (the default with a CUDA device) or "gloo" (the default
    without); "nccl" without a CUDA device raises.  Idempotent: a second
    call joins nothing and returns the same device.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device; this process sees none")
    if not dist.is_initialized():
        init = "env://"
        if coordinator_address is not None:
            init = (coordinator_address if "://" in coordinator_address
                    else f"tcp://{coordinator_address}")
        kwargs = {}
        world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
        rank_ = process_id if process_id is not None else os.environ.get("RANK")
        if world is not None:
            kwargs["world_size"] = int(world)
        if rank_ is not None:
            kwargs["rank"] = int(rank_)
        if timeout is not None:
            kwargs["timeout"] = timeout
        dist.init_process_group(backend, init_method=init, **kwargs)
    device = _device(dist.get_backend(), local_device_ids, dist.get_rank())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def world_size() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the process that logs and writes checkpoints."""
    return rank() == 0


def shard_of(group) -> Tuple[int, int]:
    """(this rank's index, the number of ranks) in ``group``; (0, 1) for
    None (one process)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    """Run ``op(flat)`` on one flat copy of each dtype's tensors and copy
    the result back in place."""
    for ts in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over ``group``, in place (one collective per dtype).
    Every rank receives the same bits."""
    if group is not None and tensors:
        _flat_collective(tensors, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_(tensors: Sequence[torch.Tensor], group) -> None:
    """Overwrite each tensor with that of ``group``'s first rank, in place."""
    if group is not None and tensors:
        src = dist.get_process_group_ranks(group)[0]
        _flat_collective(tensors, lambda flat: dist.broadcast(flat, src, group=group))


def host_group(group):
    """A gloo group over ``group``'s ranks: ``group`` itself under gloo,
    else one made once (a collective call: every rank makes it at the same
    point)."""
    if dist.get_backend(group) == "gloo":
        return group
    if group not in _host_groups:
        ranks = dist.get_process_group_ranks(group)
        _host_groups[group] = dist.new_group(ranks=ranks, backend="gloo")
    return _host_groups[group]


def host_gather(obj: Any, group) -> List[Any]:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=host_group(group))
    return out


def barrier(group) -> None:
    """Wait for every rank of ``group`` (none for None)."""
    if group is not None:
        dist.barrier(group=host_group(group))
