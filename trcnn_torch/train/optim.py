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
- conv1_1-conv2_2 are frozen: their update is zero.  Their trace still
  follows the JAX package's optax chain (weight decay enters it, the update
  is masked after the trace), so that a trace crosses to the port and back
  (``trcnn_torch/convert.py``) and stays equal step for step;
- the optional global-norm clip scales every gradient first.

The schedule is piecewise constant (x ``lr_decay_factor`` from
``lr_decay_step`` on) with the optional linear warmup, in float32 like
optax's.  The update runs in place, on the parameters and on the momentum
buffers.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from trcnn_torch.config import OptimConfig
from trcnn_torch.models.vgg16 import FROZEN_PREFIXES


def is_frozen(name: str) -> bool:
    """True for a parameter of conv1_1-conv2_2 (``extractor.conv1_1.weight``)."""
    parts = name.split(".")
    return parts[0] == "extractor" and parts[1].startswith(FROZEN_PREFIXES)


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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, float32, on the
    tensors' device (no host sync)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class CaffeSGD:
    """Caffe-order MomentumSGD over a model's parameters, keyed by name."""

    def __init__(self, model: nn.Module, cfg: OptimConfig = OptimConfig()):
        self.cfg = cfg
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
            if not is_frozen(name):
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
