"""Fast R-CNN RoI head, VGG-16 variant (port of ``trcnn/models/roi_head.py``).

fc6 (+ReLU) and fc7 (+ReLU) run in the compute dtype; cls_score and
bbox_pred run in float32.  The pooled (R, 7, 7, C) NHWC crop flattens in
(h, w, c) order, the row order of fc6's canonical weight, so fc6 needs no
permutation.  Dropout is an inference no-op and is left out: this slice has
no training path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``x @ W.T`` in x.dtype, then the bias in x.dtype (flax's order)."""
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


class VGG16RoIHead(nn.Module):
    def __init__(self, in_features: int = 7 * 7 * 512, num_classes: int = 21,
                 hidden: int = 4096, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc6 = nn.Linear(in_features, hidden, device=device)
        self.fc7 = nn.Linear(hidden, hidden, device=device)
        self.cls_score = nn.Linear(hidden, num_classes, device=device)
        self.bbox_pred = nn.Linear(hidden, 4 * num_classes, device=device)

    def forward(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled (R, P, P, C) -> (cls_score (R, K), bbox_pred (R, 4K)), f32."""
        y = pooled.reshape(pooled.shape[0], -1).to(self.dtype)
        y = torch.relu(dense(y, self.fc6))
        y = torch.relu(dense(y, self.fc7))
        y = y.float()
        return dense(y, self.cls_score), dense(y, self.bbox_pred)
