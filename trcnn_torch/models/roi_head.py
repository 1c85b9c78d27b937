"""Fast R-CNN RoI head, VGG-16 variant (port of ``trcnn/models/roi_head.py``).

fc6 (+ReLU) and fc7 (+ReLU) run in the compute dtype; cls_score and
bbox_pred run in float32.  The pooled (R, 7, 7, C) NHWC crop flattens in
(h, w, c) order, the row order of fc6's canonical weight, so fc6 needs no
permutation.  In training, dropout follows the fc6 and fc7 ReLUs: the mask
is drawn from the caller's generator and kept values are divided by the
keep probability, as flax's ``nn.Dropout`` does (``F.dropout`` takes no
generator).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trcnn_torch.ops.quant import qdense


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``x @ W.T`` in x.dtype, then the bias in x.dtype (flax's order)."""
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


class VGG16RoIHead(nn.Module):
    def __init__(self, in_features: int = 7 * 7 * 512, num_classes: int = 21,
                 hidden: int = 4096, dtype: torch.dtype = torch.float32, device=None,
                 dropout_rate: float = 0.5, quant: str = "none"):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.quant = quant
        self.fc6 = nn.Linear(in_features, hidden, device=device)
        self.fc7 = nn.Linear(hidden, hidden, device=device)
        self.cls_score = nn.Linear(hidden, num_classes, device=device)
        self.bbox_pred = nn.Linear(hidden, 4 * num_classes, device=device)

    def _dropout(self, y: torch.Tensor, generator) -> torch.Tensor:
        keep = 1.0 - self.dropout_rate
        if generator is None or keep == 1.0:
            return y
        mask = torch.empty_like(y).bernoulli_(keep, generator=generator).bool()
        return torch.where(mask, y / keep, 0.0)

    def _fc(self, y: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        if self.quant == "int8":
            return torch.relu(qdense(y, layer).to(self.dtype))
        return torch.relu(dense(y, layer))

    def forward(self, pooled: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled (R, P, P, C) -> (cls_score (R, K), bbox_pred (R, 4K)), f32.
        ``generator``: draws the dropout masks; None is the deterministic
        (inference) head."""
        y = pooled.reshape(pooled.shape[0], -1).to(self.dtype)
        y = self._dropout(self._fc(y, self.fc6), generator)
        y = self._dropout(self._fc(y, self.fc7), generator)
        y = y.float()
        return dense(y, self.cls_score), dense(y, self.bbox_pred)
