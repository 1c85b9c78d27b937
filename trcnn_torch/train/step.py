"""The train step, on one device or over a (data, model) grid of
processes (port of ``trcnn/train/step.py``).

One step: the training forward (``FasterRCNN.losses``), backward, the
gradients' global norm, and the Caffe-order update, all on the device the
model lives on; nothing waits on the device.  The step's generator, which
draws the sampling uniforms and the dropout masks, is seeded from
(seed, step): a run resumed from a checkpoint draws what an uninterrupted
one would, as the JAX step's ``fold_in(rng, state.step)`` does.  The
generators' numbers are not JAX's; the tests hand in JAX's draws.  The
three stages run under the spans named in ``STAGES``
(``trcnn_torch.utils.profiling.span``: a ``record_function`` while a
profiler records, a flag read otherwise).  :func:`train_steps` takes K steps
in one call (JAX's ``inner_steps=K``).

The JAX step's (data, model) mesh is a grid of ``torch.distributed``
processes (:func:`trcnn_torch.parallel.make_mesh`).  Over ``data`` every
rank takes its own equal shard of the global batch (:func:`device_batch`,
its loader's ``shard_id`` is its data index) and computes its share of the
global batch's losses (``FasterRCNN.losses`` over the data group).  Over
``model`` fc6 and fc7 are sharded Megatron-style
(:mod:`trcnn_torch.parallel.tensor`, the head's collectives); every other
parameter is replicated.  :meth:`TrainState.create` (the counterpart of
``create_sharded``) broadcasts rank 0's parameters over the world, then
keeps this rank's fc6/fc7 blocks.  After backward (which has summed the
head input's and fc6 bias's gradients over the model group) one
all-reduce over the data group sums the gradients, flattened into one
buffer, and one broadcast over the model group hands its first rank's
replicated gradients to the others (on the card two ranks computing the
same gradient differ in the last bits: the backward adds with atomics),
before the global norm (each fc6/fc7 block's squares summed over the
model group), the clip and the update, so that the replicas apply the
same update to the same bits; the metrics are summed to the global
batch's over the data group.  The data-axis reduction is written out
rather than left to DDP's hooks: VGG-16's conv1 block runs in the
forward-only kernel K3 and never has a gradient, which DDP would take for
an error, and one sum after backward is what XLA inserts from the JAX
mesh's shardings.  ``batch_sharding`` has no counterpart: a rank's rows
of the batch are its loader's shard.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from trcnn_torch import parallel
from trcnn_torch.data.loader import Batch, upload
from trcnn_torch.models.faster_rcnn import FasterRCNN
from trcnn_torch.parallel.tensor import param_shardings, shard_model_
from trcnn_torch.train.optim import CaffeSGD, global_norm
from trcnn_torch.utils.profiling import span

BATCH_KEYS = ("images", "im_info", "gt_boxes", "gt_labels", "gt_valid")
# the step's profiler spans, in order
STAGES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


@dataclasses.dataclass
class TrainState:
    """The model (float32 master parameters; over a grid, this rank's
    fc6/fc7 blocks), its optimizer, the number of steps taken and the
    (data, model) grid (1 x 1: one process).  :func:`train_step` updates
    the first three in place."""

    model: FasterRCNN
    optimizer: CaffeSGD
    step: int = 0
    mesh: parallel.Mesh = parallel.Mesh()

    @property
    def group(self):
        """The data-parallel group (None: no other data rank)."""
        return self.mesh.data

    @classmethod
    def create(cls, model: FasterRCNN, mesh: parallel.Mesh = parallel.Mesh()) -> "TrainState":
        """The state of a fresh run on ``mesh``: every rank's parameters and
        buffers are overwritten with rank 0's, so that the replicas start
        from the same bits, then fc6/fc7 are cut to this rank's blocks (a
        width the model axis does not divide raises)."""
        with torch.no_grad():
            world = None if mesh.data is None and mesh.model is None else dist.group.WORLD
            parallel.broadcast_(list(model.parameters()) + list(model.buffers()), world)
        shard_model_(model, mesh)
        return cls(model, CaffeSGD(model, model.cfg.optim, model.cfg.backbone), mesh=mesh)


def device_batch(batch: Union[Batch, Mapping[str, torch.Tensor]], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """A loader Batch (numpy) or a dict of tensors -> the five
    ``BATCH_KEYS`` tensors on ``device``; host memory goes to the card
    through pinned buffers, asynchronously.  Data-parallel, each process
    uploads only its own shard (its loader's ``shard_id``), as
    ``jax.make_array_from_process_local_data`` lifts each process's rows
    into the global batch; over a grid the shard is the data index's, the
    same on every model rank of it."""
    if isinstance(batch, Batch):
        return {k: upload(getattr(batch, k), device) for k in BATCH_KEYS}
    out = {}
    for k in BATCH_KEYS:
        t = batch[k]
        if t.device.type == "cpu" and device.type == "cuda":
            t = t.contiguous().pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded ``seed``, on ``device``."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int = 0,
               uniforms: Optional[Dict[str, torch.Tensor]] = None,
               proposals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step, in place on ``state``.

    ``batch``: images (B, H, W, 3), im_info (B, 3), gt_boxes (B, G, 4),
    gt_labels (B, G), gt_valid (B, G), on the model's device: this data
    index's shard over a grid.  ``uniforms`` and ``proposals``
    replace the generator's sampling draws and the proposal layer's output
    for the same images (tests).  Returns the losses dict plus
    ``grad_norm`` (the global norm over every gradient, the frozen ones
    counted as zero), as 0-d tensors on the device: the global batch's
    values, on every rank.
    """
    model = state.model
    model.train()
    gen = step_generator(seed, state.step, batch["images"].device)
    with span(STAGES[0]):
        out = model.losses(*(batch[k] for k in BATCH_KEYS), generator=gen, uniforms=uniforms,
                           proposals=proposals, group=state.group)
    with span(STAGES[1]):
        model.zero_grad(set_to_none=True)
        out["loss"].backward()
        kinds = param_shardings(model)
        named = [(k, p.grad) for k, p in model.named_parameters() if p.grad is not None]
        grads = [g for _, g in named]
        parallel.all_reduce_sum_(grads, state.mesh.data)
        # the model ranks of a data index compute the replicated gradients
        # alike, but on the card the backward's atomics part their last bits
        parallel.broadcast_([g for k, g in named if kinds[k] is None], state.mesh.model)
    with span(STAGES[2]):
        norm = global_norm(grads, [kinds[k] is not None for k, _ in named], state.mesh.model)
        state.optimizer.step(state.step, norm)
    state.step += 1
    metrics = {k: v.detach() for k, v in out.items()}
    if state.group is not None:
        values = torch.stack(list(metrics.values()))
        parallel.all_reduce_sum_([values], state.group)
        metrics = dict(zip(metrics, values.unbind()))
    metrics["grad_norm"] = norm
    return metrics


def train_steps(state: TrainState, batches: Dict[str, torch.Tensor], seed: int = 0
                ) -> Dict[str, torch.Tensor]:
    """K optimizer steps in one call, in place on ``state``: the
    counterpart of ``make_train_step(..., inner_steps=K)``.

    Every array of ``batches`` (the five ``BATCH_KEYS``) carries a leading
    K axis, one slice per step.  The steps are :func:`train_step`'s, one
    after the other with nothing read back to the host between them, each
    drawing from ``step_generator(seed, state.step)`` as K separate calls
    would (the JAX scan folds ``state.step`` into its key alike), and over
    the (data, model) grid as it does.  Returns the last step's metrics."""
    k = batches["images"].shape[0]
    if k < 1 or any(batches[key].shape[0] != k for key in BATCH_KEYS):
        raise ValueError("every array of batches needs the same leading K axis, K >= 1: "
                         + ", ".join(f"{key} {tuple(batches[key].shape)}" for key in BATCH_KEYS))
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(k):
        metrics = train_step(state, {key: batches[key][i] for key in BATCH_KEYS}, seed)
    return metrics
