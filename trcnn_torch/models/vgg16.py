"""VGG-16 convolutional trunk (port of ``trcnn/models/vgg16.py``).

13 convolutions, 3x3 SAME, each followed by ReLU; a 2x2/2 max pool after
every block but the last; stride 16, 512-channel conv5_3 output.  Input and
output are NHWC.  conv1_1 + conv1_2 + pool1 run through the fused stem
(kernel K3 on the card, as ``vgg16.py:87-98`` runs the Pallas stem on the
TPU); the other convolutions are ``F.conv2d`` on a channels-last view, so
the NHWC output needs no copy.

conv1_1-conv2_2 are frozen (the reference recipe): they run without
autograd, the counterpart of the JAX package's ``stop_gradient`` after
conv2_2's ReLU (``vgg16.py:122-123``), so no gradient reaches them and none
of their backward is computed.  K3 is forward only, as the JAX stem is.

Parameters stay float32 unless ``cast_params_for_inference`` narrowed the
weights; every layer casts its weight and bias to the compute dtype at use,
and adds the bias after rounding the convolution to that dtype, as flax's
``nn.Conv`` does.

``quant="int8"`` (inference only) runs conv2_1 ... conv5_3 as dynamic int8
products (``ops/quant.qconv2d``: float32 output with the bias added, then
cast to the compute dtype, then ReLU), as ``trcnn/models/vgg16.py:129-150``
does; block 1 stays full precision through the stem.  The parameters are
the float model's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trcnn_torch.ops.quant import qconv2d
from trcnn_torch.ops.stem import stem_block1

# (block, convs in block, channels)
VGG_CFG: Tuple[Tuple[str, int, int], ...] = (
    ("conv1", 2, 64),
    ("conv2", 2, 128),
    ("conv3", 3, 256),
    ("conv4", 3, 512),
    ("conv5", 3, 512),
)

# parameters frozen in detection training (trcnn/models/vgg16.py:47)
FROZEN_PREFIXES: Tuple[str, ...] = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")


def conv_nchw(x: torch.Tensor, conv: nn.Conv2d, relu: bool = True) -> torch.Tensor:
    """``conv`` in x.dtype with flax's rounding order: convolution, then bias,
    then ReLU, each in the compute dtype."""
    y = F.conv2d(x, conv.weight.to(x.dtype), padding=conv.padding)
    y = y + conv.bias.to(x.dtype).view(1, -1, 1, 1)
    return torch.relu(y) if relu else y


class VGG16(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, device=None, quant: str = "none"):
        super().__init__()
        self.dtype = dtype
        self.quant = quant
        in_ch = 3
        for name, n_convs, ch in VGG_CFG:
            for ci in range(n_convs):
                self.add_module(f"{name}_{ci + 1}",
                                nn.Conv2d(in_ch, ch, 3, padding=1, device=device))
                in_ch = ch

    def _conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        """conv2_1 ... conv5_3 + ReLU on a channels-last NCHW view."""
        if self.quant == "int8":
            y = qconv2d(x.permute(0, 2, 3, 1), conv).to(self.dtype)
            return torch.relu(y).permute(0, 3, 1, 2)
        return conv_nchw(x, conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC, H and W multiples of 16 -> (B, H/16, W/16, 512)."""
        c11, c12 = self.conv1_1, self.conv1_2
        with torch.no_grad():                     # the frozen stem
            x = stem_block1(x.to(self.dtype).contiguous(), c11.weight, c11.bias,
                            c12.weight, c12.bias)
            x = x.permute(0, 3, 1, 2)             # channels-last NCHW view
            x = self._conv(self._conv(x, self.conv2_1), self.conv2_2)
        for name, n_convs, _ in VGG_CFG[2:]:
            x = F.max_pool2d(x, 2, 2)
            for ci in range(n_convs):
                x = self._conv(x, getattr(self, f"{name}_{ci + 1}"))
        return x.permute(0, 2, 3, 1).contiguous()
