"""fc6/fc7 tensor parallelism over a mesh's ``model`` axis (port of
``trcnn/train/step.py:69-84`` ``param_shardings`` and of what XLA makes
of it).

The JAX package shards two kernels over ``model``, Megatron-style, and
replicates every other parameter, the biases included: fc6's kernel is
``P(None, "model")`` (column-parallel) and fc7's ``P("model", None)``
(row-parallel).  torch stores ``nn.Linear.weight`` as (out, in), JAX's
kernel as (in, out), so fc6's slice is a block of **rows** of
``fc6.weight`` and fc7's a block of **columns** of ``fc7.weight``
(``DIM``).  Model rank j of n holds block j of n equal blocks.

The head's two collectives are autograd Functions with their backward
written out (:func:`copy_to_model`, :func:`reduce_from_model`); the
parameter and state helpers slice a whole tensor for this rank or gather
the slices whole again (:func:`shard_model_`, :func:`whole_state`,
:func:`load_whole_`, :func:`whole_head`; :func:`checkpoint_state` gathers
to the first rank only).  Each gather is a collective
over the model group: every rank of the grid calls it, in the same order.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# layer name -> its weight's sharding
SHARDED = {"fc6": "column", "fc7": "row"}
# the dimension of torch's (out, in) weight that each sharding splits
DIM = {"column": 0, "row": 1}


def param_shardings(model: nn.Module) -> Dict[str, Optional[str]]:
    """Parameter name -> "column" (fc6's weight), "row" (fc7's weight) or
    None (replicated).  ResNet-101-C4 has no fc6/fc7: every parameter is
    replicated, and a model axis above 1 repeats its work on each model
    rank, as under the JAX mesh."""
    out = {}
    for name, _ in model.named_parameters():
        layer, _, leaf = name.rpartition(".")
        out[name] = SHARDED.get(layer.rpartition(".")[2]) if leaf == "weight" else None
    return out


def local_slice(t: torch.Tensor, kind: str, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (a copy)."""
    dim = DIM[kind]
    width = t.shape[dim]
    if width % mesh.n_model:
        raise ValueError(f"a {kind}-parallel width of {width} does not split over a model "
                         f"axis of {mesh.n_model}")
    w = width // mesh.n_model
    return t.narrow(dim, mesh.model_index * w, w).clone()


def gather(t: torch.Tensor, kind: str, mesh) -> torch.Tensor:
    """The whole tensor from every model rank's block ``t`` (bit-exact: a
    copy of each block); ``t`` itself without a model group."""
    if mesh.model is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model)
    return torch.cat(parts, DIM[kind])


def _owners(model: nn.Module) -> Iterator[Tuple[str, str, nn.Module]]:
    """(parameter name, sharding, the module holding the sharded layer) of
    every sharded parameter: that module (the RoI head) runs the model
    group's collectives in its forward."""
    for name, kind in param_shardings(model).items():
        if kind:
            yield name, kind, model.get_submodule(name.rpartition(".")[0].rpartition(".")[0])


@torch.no_grad()
def shard_model_(model: nn.Module, mesh) -> None:
    """Replace each sharded parameter of the whole model by this rank's
    block, in place, and hand ``mesh`` to the module that holds it; nothing
    changes on a model axis of 1."""
    if mesh.n_model == 1:
        return
    params = dict(model.named_parameters())
    for name, kind, owner in _owners(model):
        params[name].data = local_slice(params[name].data, kind, mesh)
        owner.mesh = mesh


def _mesh_of(model: nn.Module):
    for _, _, owner in _owners(model):
        if owner.mesh is not None:
            return owner.mesh
    return None


@torch.no_grad()
def whole_state(model: nn.Module, momentum: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(``model.state_dict()``, ``momentum``) with each sharded tensor
    gathered whole: the one-process state, on every rank of the model
    group, which all call it."""
    sd, mom = model.state_dict(), dict(momentum)
    mesh = _mesh_of(model)
    if mesh is not None:
        for name, kind, _ in _owners(model):
            sd[name] = gather(sd[name], kind, mesh)
            mom[name] = gather(mom[name], kind, mesh)
    return sd, mom


@torch.no_grad()
def checkpoint_state(model: nn.Module, momentum: Dict[str, torch.Tensor]
                     ) -> Optional[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """What :func:`whole_state` returns, on the first rank of the world
    only, which writes checkpoints; None on every other rank of a grid.

    Only the model group of data index 0 (which holds the first rank)
    takes part: each of its ranks copies its fc6/fc7 blocks and their
    momentum to host memory and sends them to the first rank
    (``dist.gather`` over the group's gloo group: gloo gathers host
    tensors only), which concatenates them and puts the whole tensors on
    its own device, where the one-process state lives, so that the
    checkpoint's bytes are one process's.  No other rank holds a whole
    fc6/fc7 tensor, on the device or on the host.  Without a model group
    every rank gets its own state."""
    sd, mom = model.state_dict(), dict(momentum)
    mesh = _mesh_of(model)
    if mesh is None:
        return sd, mom
    if mesh.data_index:
        return None
    from trcnn_torch import parallel

    group = parallel.host_group(mesh.model)
    first = dist.get_process_group_ranks(mesh.model)[0]
    mine = dist.get_rank() == first
    for name, kind, _ in _owners(model):
        for tree in (sd, mom):
            block = tree[name].detach().cpu()
            parts = [torch.empty_like(block) for _ in range(mesh.n_model)] if mine else None
            dist.gather(block, parts, dst=first, group=group)
            if mine:
                tree[name] = torch.cat(parts, DIM[kind]).to(tree[name].device)
    return (sd, mom) if mine else None


@torch.no_grad()
def load_whole_(model: nn.Module, optimizer, state: Dict[str, torch.Tensor],
                momentum: Dict[str, torch.Tensor]) -> None:
    """Load a one-process state (whole tensors, e.g. a checkpoint's) into
    the model and its optimizer, each sharded tensor sliced for this rank
    of the model's mesh."""
    mesh = _mesh_of(model)
    state, momentum = dict(state), dict(momentum)
    if mesh is not None:
        for name, kind, _ in _owners(model):
            state[name] = local_slice(state[name], kind, mesh)
            momentum[name] = local_slice(momentum[name], kind, mesh)
    model.load_state_dict(state)
    optimizer.load_state_dict({"momentum": momentum})


@contextlib.contextmanager
def whole_head(model: nn.Module):
    """fc6/fc7 gathered whole and the head unsharded for the duration, as
    JAX's ``make_detect_step`` takes the parameters replicated
    (``trcnn/train/step.py:203-205``); every rank of the model group
    enters.  Nothing happens to an unsharded model."""
    mesh = _mesh_of(model)
    if mesh is None:
        yield model
        return
    params = dict(model.named_parameters())
    saved = {}
    with torch.no_grad():
        for name, kind, owner in _owners(model):
            saved[name] = params[name].data
            params[name].data = gather(saved[name], kind, mesh)
            owner.mesh = None
    try:
        yield model
    finally:
        for name, _, owner in _owners(model):
            params[name].data = saved[name]
            owner.mesh = mesh


class _CopyToModel(torch.autograd.Function):
    """The identity forward; backward sums the gradient over the model
    group, in float32, rounded once to its dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.to(torch.float32, copy=True)
        dist.all_reduce(s, group=ctx.group)
        return s.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward, in float32, rounded once to
    the input's dtype; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        s = x.to(torch.float32, copy=True)
        dist.all_reduce(s, group=group)
        return s.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group`` (a
    column-parallel layer's input: each model rank's gradient holds its
    columns' share)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every model rank's ``x`` (a row-parallel layer's partial
    products); the gradient passes unchanged to each."""
    return _ReduceFromModel.apply(x, group)
