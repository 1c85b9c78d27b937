"""Data and tensor parallelism over ``torch.distributed`` (port of
``trcnn/parallel`` and the mesh of ``trcnn/train/step.py``).

The JAX package scales out over a (data, model) device mesh: batch arrays
shard over ``data``; fc6's and fc7's kernels shard over ``model``
(Megatron-style, column then row parallel); every other parameter
replicates; and XLA inserts the collectives from the shardings.  The port
runs one process per device in a ``torch.distributed`` group:

  * :func:`initialize` -- ``init_process_group`` with the arguments of
    ``jax.distributed.initialize``; with none of them, the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``, as ``torchrun`` sets them), the counterpart of the TPU
    metadata auto-detect.  It selects the rank's device and returns it.
  * :func:`make_mesh` -- the (data, model) grid of the group's processes
    (:class:`Mesh`): rank r sits at (r // n_model, r % n_model), the
    row-major reshape of ``make_mesh``'s devices; its ``data`` group joins
    the ranks of one model index (gradients and metrics are summed there),
    its ``model`` group the ranks of one data index (fc6/fc7's collectives,
    :mod:`trcnn_torch.parallel.tensor`).
  * :func:`is_main_process`, :func:`world_size`, :func:`rank`: the process
    that logs and writes checkpoints; 1 and 0 when no group exists.
  * :func:`all_reduce_sum_`, :func:`broadcast_`: in-place collectives over
    a list of tensors, flattened into one buffer per dtype (the gradient
    sum of the data-parallel step, the replicas' parameters at creation).
  * :func:`host_gather`: every rank's Python object, in rank order, over a
    gloo group (the evaluator's detections), beside an NCCL group if the
    group is one.

A ``group`` argument of None means one process with no collective at all.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_main_process", "world_size", "rank", "Mesh", "make_mesh"]

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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of processes, as this rank sees it: the grid's
    shape, this rank's (data index, model index), and its two groups.
    ``data``: the ranks of this model index (None for one of them);
    ``model``: the ranks of this data index (None for one).  The default is
    one process: 1 x 1, no group."""

    n_data: int = 1
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data: Any = None
    model: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


def _new_group(ranks: List[int]):
    """``dist.new_group`` over ``ranks``, with its gloo group beside it
    when the backend is not gloo; every rank of the world makes every group
    (a collective call), members or not."""
    group = dist.new_group(ranks=ranks)
    host = group if dist.get_backend() == "gloo" else dist.new_group(ranks=ranks, backend="gloo")
    if dist.get_rank() in ranks:
        _host_groups[group] = host
        return group
    return None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) grid of the default group's processes
    (``trcnn/train/step.py:51-58``): ``n_data`` defaults to the world size
    over ``n_model``, and ``n_data * n_model`` must be the world size.
    With ``n_model`` 1 the data group is the default group itself (data
    parallelism alone); otherwise every rank makes every data group, then
    every model group, in that order.  Without a process group only the
    1 x 1 grid exists."""
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} (data, model) grid needs {n_data * n_model} "
                         f"processes; the group has {world}")
    if not dist.is_initialized():
        return Mesh()
    d, m = divmod(rank(), n_model)
    if n_model == 1:
        return Mesh(n_data, 1, d, 0, dist.group.WORLD, None)
    data = model = None
    for j in range(n_model):
        if n_data > 1:
            g = _new_group(list(range(j, world, n_model)))
            data = g if j == m else data
    for i in range(n_data):
        g = _new_group(list(range(i * n_model, (i + 1) * n_model)))
        model = g if i == d else model
    return Mesh(n_data, n_model, d, m, data, model)


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
