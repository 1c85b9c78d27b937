"""Optimizer: MomentumSGD with Caffe parameter-group semantics (port of
``trcnn/train/optim.py``).

The learning rate scales the gradient BEFORE the momentum trace, Caffe's
order:

    v = m * v - lr * (g + wd * w);    w += v

so at the decay step the accumulated velocity decays over about 1/(1 - m)
steps, as the reference's does.  ``torch.optim.SGD`` applies the learning
rate after the momentum and differs there, so this module writes its own
update.  The per-parameter rules:

- biases (ndim <= 1) train at 2x the learning rate and take no decay;
- frozen parameters take a zero update: VGG-16's conv1_1-conv2_2;
  ResNet-101's conv1, bn1, res2 and every FrozenBN leaf (a path component
  holding "bn").  Their trace still follows the JAX package's optax chain
  (weight decay and the gradient enter it, the update is masked after the
  trace), so that a trace crosses to the port and back
  (``trcnn_torch/convert.py``) and stays equal step for step.  The
  FrozenBN leaves of res3-res5 take gradients, as JAX's do, so their
  gradients count in the global norm and the clip as well;
- the optional global-norm clip scales every gradient first.

Over a (data, model) grid the parameters, gradients and traces of fc6's
and fc7's weights are this rank's blocks (``trcnn_torch.parallel.tensor``):
the update is elementwise, so each rank updates its block, and
:func:`global_norm` counts each block's squares over the model group.

The schedule is piecewise constant (x ``lr_decay_factor`` from
``lr_decay_step`` on) with the optional linear warmup, in float32 like
optax's.  The update runs in place, on the parameters and on the momentum
buffers.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from trcnn_torch import parallel
from trcnn_torch.config import OptimConfig
from trcnn_torch.models import resnet, vgg16


def is_frozen(name: str, backbone: str = "vgg16") -> bool:
    """True for a frozen parameter (``trcnn/train/optim.py:35-56``): under
    ``extractor``, one of the backbone's frozen prefixes (VGG-16
    ``extractor.conv1_1.weight``; ResNet-101 conv1, bn1, res2), and for
    ResNet-101 every parameter with "bn" in a path component."""
    parts = name.split(".")
    prefixes = vgg16.FROZEN_PREFIXES if backbone == "vgg16" else resnet.FROZEN_PREFIXES
    if parts[0] == "extractor" and parts[1].startswith(prefixes):
        return True
    return backbone != "vgg16" and any("bn" in p for p in parts)


def learning_rate(cfg: OptimConfig, step: int) -> float:
    """The schedule at ``step``, rounded as optax's float32 arithmetic is
    (``trcnn/train/optim.py:64-78``)."""
    f32 = np.float32
    base_lr = f32(cfg.base_lr)
    indicator = f32(0.0 if step >= cfg.lr_decay_step else 1.0)
    lr = base_lr * indicator + (f32(1.0) - indicator) * f32(cfg.lr_decay_factor) * base_lr
    if cfg.warmup_steps > 0:
        frac = min(f32(step) / f32(cfg.warmup_steps), f32(1.0))
        scale = f32(cfg.warmup_factor) + f32(1.0 - cfg.warmup_factor) * frac
        lr = min(lr, base_lr * scale)
    return float(lr)


def global_norm(tensors: Iterable[torch.Tensor], sharded: Sequence[bool] = (),
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, float32, on the
    tensors' device (no host sync).  ``sharded``: a flag per tensor, True
    for this rank's block of a tensor sharded over the model group
    ``group``, whose sum of squares is summed over the group (one
    collective on every model rank); every other tensor counts once."""
    squares = torch.stack([t.float().square().sum() for t in tensors])
    blocks = [i for i, s in enumerate(sharded) if s]
    if group is not None and blocks:
        part = squares[blocks]
        parallel.all_reduce_sum_([part], group)
        squares[blocks] = part
    return squares.sum().sqrt()


class CaffeSGD:
    """Caffe-order MomentumSGD over a model's parameters, keyed by name."""

    def __init__(self, model: nn.Module, cfg: OptimConfig = OptimConfig(),
                 backbone: str = "vgg16"):
        self.cfg = cfg
        self.frozen = {name for name, _ in model.named_parameters() if is_frozen(name, backbone)}
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.momentum: Dict[str, torch.Tensor] = {
            name: torch.zeros_like(p) for name, p in self.params.items()}

    @torch.no_grad()
    def step(self, step: int, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Apply the update for optimizer step ``step`` (0-based) from the
        parameters' ``.grad`` (None counts as zero).  ``grad_norm``: the
        gradients' global norm, needed only when clipping."""
        cfg = self.cfg
        lr = learning_rate(cfg, step)
        for name, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if cfg.clip_grad_norm > 0:
                clipped = (g / grad_norm) * cfg.clip_grad_norm
                g = torch.where(grad_norm < cfg.clip_grad_norm, g, clipped)
            if p.dim() > 1:
                u = (g + cfg.weight_decay * p) * -lr
            else:
                u = g * (-2.0 * lr)
            v = self.momentum[name]
            v.mul_(cfg.momentum).add_(u)
            if name not in self.frozen:
                p.add_(v)

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"momentum": dict(self.momentum)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        momentum = state["momentum"]
        if momentum.keys() != self.momentum.keys():
            raise ValueError("momentum buffers do not match the model's parameters")
        for name, v in momentum.items():
            self.momentum[name].copy_(v)
