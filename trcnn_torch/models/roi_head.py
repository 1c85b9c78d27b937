"""Fast R-CNN RoI head, VGG-16 variant (port of ``trcnn/models/roi_head.py``).

fc6 (+ReLU) and fc7 (+ReLU) run in the compute dtype; cls_score and
bbox_pred run in float32.  The pooled (R, 7, 7, C) NHWC crop flattens in
(h, w, c) order, the row order of fc6's canonical weight, so fc6 needs no
permutation.  In training, dropout follows the fc6 and fc7 ReLUs: the mask
is drawn from the caller's generator and kept values are divided by the
keep probability, as flax's ``nn.Dropout`` does (``F.dropout`` takes no
generator); a data-parallel rank keeps its rows of the global batch's
masks.

Sharded over a mesh's ``model`` axis (``mesh``, set by
:func:`trcnn_torch.parallel.tensor.shard_model_`), the head holds its
block of fc6's output rows and of fc7's input columns, Megatron-style:
the pooled input enters through the identity whose backward sums the
gradient over the model group (the RoI pool's gradient is whole before
K4 runs); each rank adds its columns of the replicated fc6 bias (whose
gradient is summed the same way, so the replicas keep one bias) and
applies the ReLU; fc7's partial products are summed over the group in
float32 and rounded once, then fc7's bias is added once.  The dropout
masks are the whole head's (rows of the global batch, every column),
of which fc6's keeps this rank's columns, so a grid draws what one
process draws.  Both collectives run on every model rank in every call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trcnn_torch.ops.quant import qdense
from trcnn_torch.parallel.tensor import copy_to_model, reduce_from_model


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
        self.mesh = None            # the (data, model) grid fc6/fc7 are sharded over

    def _dropout(self, y: torch.Tensor, generator, shard: Tuple[int, int],
                 cols: slice = slice(None)) -> torch.Tensor:
        """The dropout of the global batch's (n * rows, hidden) mask, of
        which this rank keeps rows i of n blocks and the columns ``cols``."""
        keep = 1.0 - self.dropout_rate
        if generator is None or keep == 1.0:
            return y
        i, n = shard
        rows = y.shape[0]
        mask = torch.empty((n * rows, self.fc7.bias.shape[0]), dtype=y.dtype, device=y.device)
        mask = mask.bernoulli_(keep, generator=generator)[i * rows:(i + 1) * rows, cols].bool()
        return torch.where(mask, y / keep, 0.0)

    def _fc(self, y: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        if self.quant == "int8":
            return torch.relu(qdense(y, layer).to(self.dtype))
        return torch.relu(dense(y, layer))

    def _sharded_fc(self, y: torch.Tensor, generator, shard: Tuple[int, int]) -> torch.Tensor:
        """fc6 (column-parallel) and fc7 (row-parallel) with their ReLUs and
        dropouts over the mesh's model group."""
        group, dt = self.mesh.model, self.dtype
        w = self.fc6.weight.shape[0]
        cols = slice(self.mesh.model_index * w, (self.mesh.model_index + 1) * w)
        bias = copy_to_model(self.fc6.bias, group)[cols]
        y = torch.relu(F.linear(copy_to_model(y, group), self.fc6.weight.to(dt)) + bias.to(dt))
        y = self._dropout(y, generator, shard, cols)
        y = reduce_from_model(F.linear(y, self.fc7.weight.to(dt)), group)
        return self._dropout(torch.relu(y + self.fc7.bias.to(dt)), generator, shard)

    def forward(self, pooled: torch.Tensor, generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled (R, P, P, C) -> (cls_score (R, K), bbox_pred (R, 4K)), f32.
        ``generator``: draws the dropout masks; None is the deterministic
        (inference) head.  ``shard`` (i, n): the masks are rows i of n
        equal blocks of the global batch's masks."""
        y = pooled.reshape(pooled.shape[0], -1).to(self.dtype)
        if self.mesh is None:
            y = self._dropout(self._fc(y, self.fc6), generator, shard)
            y = self._dropout(self._fc(y, self.fc7), generator, shard)
        else:
            y = self._sharded_fc(y, generator, shard)
        y = y.float()
        return dense(y, self.cls_score), dense(y, self.bbox_pred)
