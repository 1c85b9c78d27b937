"""VGG-16 convolutional trunk (port of ``trcnn/models/vgg16.py``).

13 convolutions, 3x3 SAME, each followed by ReLU; a 2x2/2 max pool after
every block but the last; stride 16, 512-channel conv5_3 output.  Input and
output are NHWC.  conv1_1 + conv1_2 + pool1 run through the fused stem
(kernel K3 on the card, as ``vgg16.py:87-98`` runs the Pallas stem on the
TPU); the other convolutions are ``F.conv2d`` on a channels-last view, so
the NHWC output needs no copy.

Parameters stay float32 unless ``cast_params_for_inference`` narrowed the
weights; every layer casts its weight and bias to the compute dtype at use,
and adds the bias after rounding the convolution to that dtype, as flax's
``nn.Conv`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trcnn_torch.ops.stem import stem_block1

# (block, convs in block, channels)
VGG_CFG: Tuple[Tuple[str, int, int], ...] = (
    ("conv1", 2, 64),
    ("conv2", 2, 128),
    ("conv3", 3, 256),
    ("conv4", 3, 512),
    ("conv5", 3, 512),
)


def conv_nchw(x: torch.Tensor, conv: nn.Conv2d, relu: bool = True) -> torch.Tensor:
    """``conv`` in x.dtype with flax's rounding order: convolution, then bias,
    then ReLU, each in the compute dtype."""
    y = F.conv2d(x, conv.weight.to(x.dtype), padding=conv.padding)
    y = y + conv.bias.to(x.dtype).view(1, -1, 1, 1)
    return torch.relu(y) if relu else y


class VGG16(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        in_ch = 3
        for name, n_convs, ch in VGG_CFG:
            for ci in range(n_convs):
                self.add_module(f"{name}_{ci + 1}",
                                nn.Conv2d(in_ch, ch, 3, padding=1, device=device))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC, H and W multiples of 16 -> (B, H/16, W/16, 512)."""
        c11, c12 = self.conv1_1, self.conv1_2
        x = stem_block1(x.to(self.dtype).contiguous(), c11.weight, c11.bias,
                        c12.weight, c12.bias)
        x = x.permute(0, 3, 1, 2)                 # channels-last NCHW view
        for bi, (name, n_convs, _) in enumerate(VGG_CFG[1:], start=1):
            for ci in range(n_convs):
                x = conv_nchw(x, getattr(self, f"{name}_{ci + 1}"))
            if bi < len(VGG_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return x.permute(0, 2, 3, 1).contiguous()
