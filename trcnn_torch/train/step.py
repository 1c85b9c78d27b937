"""The train step on one device (port of ``trcnn/train/step.py``).

One step: the training forward (``FasterRCNN.losses``), backward, the
gradients' global norm, and the Caffe-order update, all on the device the
model lives on; nothing waits on the device.  The step's generator, which
draws the sampling uniforms and the dropout masks, is seeded from
(seed, step): a run resumed from a checkpoint draws what an uninterrupted
one would, as the JAX step's ``fold_in(rng, state.step)`` does.  The
generators' numbers are not JAX's; the tests hand in JAX's draws.  The
three stages run under ``torch.profiler`` spans named in ``STAGES``, which
record nothing when no profiler runs.

The mesh and data parallelism wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from trcnn_torch.models.faster_rcnn import FasterRCNN
from trcnn_torch.train.optim import CaffeSGD, global_norm

BATCH_KEYS = ("images", "im_info", "gt_boxes", "gt_labels", "gt_valid")
# the step's profiler spans, in order
STAGES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


@dataclasses.dataclass
class TrainState:
    """The model (float32 master parameters), its optimizer and the number
    of steps taken.  :func:`train_step` updates all three in place."""

    model: FasterRCNN
    optimizer: CaffeSGD
    step: int = 0

    @classmethod
    def create(cls, model: FasterRCNN) -> "TrainState":
        return cls(model, CaffeSGD(model, model.cfg.optim, model.cfg.backbone))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded ``seed``, on ``device``."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int = 0,
               uniforms: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step, in place on ``state``.

    ``batch``: images (B, H, W, 3), im_info (B, 3), gt_boxes (B, G, 4),
    gt_labels (B, G), gt_valid (B, G), on the model's device.  ``uniforms``
    replaces the generator's sampling draws (tests).  Returns the losses
    dict plus ``grad_norm`` (the global norm over every gradient, the frozen
    ones counted as zero), as 0-d tensors on the device.
    """
    model = state.model
    model.train()
    gen = step_generator(seed, state.step, batch["images"].device)
    with record_function(STAGES[0]):
        out = model.losses(*(batch[k] for k in BATCH_KEYS), generator=gen, uniforms=uniforms)
    with record_function(STAGES[1]):
        model.zero_grad(set_to_none=True)
        out["loss"].backward()
    with record_function(STAGES[2]):
        norm = global_norm(p.grad for p in model.parameters() if p.grad is not None)
        state.optimizer.step(state.step, norm)
    state.step += 1
    metrics = {k: v.detach() for k, v in out.items()}
    metrics["grad_norm"] = norm
    return metrics
