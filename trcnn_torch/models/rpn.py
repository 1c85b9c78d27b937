"""Region Proposal Network head (port of ``trcnn/models/rpn.py``).

3x3 conv + ReLU, then sibling 1x1 convs for 2A objectness logits and 4A box
deltas.  Channel order: logits bg/fg major, anchor minor (channel a is
anchor a's background, A + a its foreground); deltas anchor major, coord
minor.  Outputs are float32 and ravel in the order of ``shifted_anchors``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from trcnn_torch.models.vgg16 import conv_nchw


class RPNOut(NamedTuple):
    fg_probs: torch.Tensor   # (B, fH, fW, A) softmax foreground probability
    logits: torch.Tensor     # (B, fH, fW, 2, A)
    deltas: torch.Tensor     # (B, fH, fW, A, 4)


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 512, num_anchors: int = 9,
                 mid_channels: int = 512, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.num_anchors = num_anchors
        self.rpn_conv = nn.Conv2d(in_channels, mid_channels, 3, padding=1, device=device)
        self.rpn_cls_score = nn.Conv2d(mid_channels, 2 * num_anchors, 1, device=device)
        self.rpn_bbox_pred = nn.Conv2d(mid_channels, 4 * num_anchors, 1, device=device)

    def forward(self, feat: torch.Tensor) -> RPNOut:
        """feat (B, fH, fW, C) NHWC."""
        a = self.num_anchors
        x = feat.to(self.dtype).permute(0, 3, 1, 2)
        h = conv_nchw(x, self.rpn_conv)
        scores = conv_nchw(h, self.rpn_cls_score, relu=False).permute(0, 2, 3, 1)
        deltas = conv_nchw(h, self.rpn_bbox_pred, relu=False).permute(0, 2, 3, 1)
        b, fh, fw, _ = scores.shape
        logits = scores.float().reshape(b, fh, fw, 2, a)
        fg_probs = torch.softmax(logits, dim=3)[..., 1, :]
        return RPNOut(fg_probs=fg_probs, logits=logits,
                      deltas=deltas.float().reshape(b, fh, fw, a, 4))
