"""ResNet-101-C4 trunk and C5 RoI head (port of ``trcnn/models/resnet.py``).

- trunk: conv1 (7x7/2, padding 3) + FrozenBN + ReLU, 3x3/2 max pool
  (padding 1, padded with -inf), res2 / res3 / res4 of 3 / 4 / 23
  bottlenecks; stride 16, 1024 channels.  conv1, bn1 and res2 run without
  autograd, the counterpart of the JAX package's ``stop_gradient`` after
  res2 (``resnet.py:134-135``): they are frozen, so no gradient reaches them
  and none of their backward is computed.
- head: res5 (3 bottlenecks, stride 2 on the 14x14 RoI crop), the spatial
  mean, then cls_score and bbox_pred in float32.  No dropout.

Every BatchNorm is frozen (``FrozenBatchNorm``): its scale, bias, mean and
var are float32 parameters, named as the flax leaves are, that the
optimizer never moves.  They take gradients as the JAX package's do: those
of res3-res5 enter the global norm, the clip and the momentum trace
(``trcnn_torch/train/optim.py``); those of conv1, bn1 and res2, which run
without autograd, are none, as JAX's are zero.  Input and output are NHWC; inside, the convolutions run on a
channels-last NCHW view, as the VGG-16 trunk's do.  Convolutions have no
bias.  Rounding follows flax's order in the compute dtype: the convolution
is rounded, then the FrozenBN's multiply and its add are each rounded
(``resnet.py:46-48``; the BN is not folded into the convolution, which
would round differently in bf16), then the residual add and the ReLU.
Each convolution's FrozenBN, residual add and ReLU run as one epilogue
(``trcnn_torch/ops/frozen_bn.py``: kernel K7 on the card), the projecting
shortcut's FrozenBN inside its block's last one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from trcnn_torch.models.roi_head import dense
from trcnn_torch.ops.frozen_bn import frozen_bn

# parameters frozen in detection training besides every FrozenBN leaf
# (trcnn/train/optim.py:28)
FROZEN_PREFIXES = ("conv1", "bn1", "res2")


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine parameters, on NCHW."""

    def __init__(self, channels: int, device=None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            self.register_parameter(name, nn.Parameter(
                torch.full((channels,), fill, device=device)))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The identity: scale 1, bias 0, mean 0, var 1 (flax's init)."""
        for p, fill in ((self.scale, 1.0), (self.bias, 0.0), (self.mean, 0.0), (self.var, 1.0)):
            p.fill_(fill)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """bn(x) alone; the model runs each FrozenBN inside its epilogue
        (:func:`trcnn_torch.ops.frozen_bn.frozen_bn`)."""
        return frozen_bn(x, self, relu=False)


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, device=None) -> nn.Conv2d:
    """A bias-free convolution, padded as flax's "SAME" for the odd kernels
    used here (1x1: none; 3x3 at stride 1: one)."""
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=False,
                     device=device)


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer`` in x.dtype (its weight cast at use)."""
    return F.conv2d(x, layer.weight.to(x.dtype), stride=layer.stride, padding=layer.padding)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """The trunk's 3x3/2 max pool on NCHW, padded by one cell with -inf on
    every side, as flax's ``nn.max_pool`` pads (``resnet.py:132``)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def spatial_mean(y: torch.Tensor) -> torch.Tensor:
    """(R, C, H, W) -> (R, C) in y's dtype, rounded as ``jnp.mean`` of y's
    dtype is: a float32 sum over the cells, one float32 division by their
    count, then one rounding to y's dtype (``resnet.py:155``)."""
    return (y.float().sum((2, 3)) / float(y.shape[2] * y.shape[3])).to(y.dtype)


class Bottleneck(nn.Module):
    """1x1 (stride here) -> 3x3 -> 1x1 residual bottleneck, with the
    projection shortcut ``proj`` + ``proj_bn`` when ``project``.  conv3 is
    zero-initialised (``init``), so a block starts as the identity."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1, project: bool = False,
                 device=None):
        super().__init__()
        out_ch = 4 * channels
        self.project = project
        if project:
            self.proj = _conv(in_ch, out_ch, 1, stride, device)
            self.proj_bn = FrozenBatchNorm(out_ch, device)
        self.conv1 = _conv(in_ch, channels, 1, stride, device)
        self.bn1 = FrozenBatchNorm(channels, device)
        self.conv2 = _conv(channels, channels, 3, 1, device)
        self.bn2 = FrozenBatchNorm(channels, device)
        self.conv3 = _conv(channels, out_ch, 1, 1, device)
        self.bn3 = FrozenBatchNorm(out_ch, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = frozen_bn(conv(x, self.conv1), self.bn1)
        y = frozen_bn(conv(y, self.conv2), self.bn2)
        y = conv(y, self.conv3)
        if self.project:
            return frozen_bn(y, self.bn3, proj=(conv(x, self.proj), self.proj_bn))
        return frozen_bn(y, self.bn3, residual=x)


class ResStage(nn.Sequential):
    """``blocks`` bottlenecks, ``block1`` projecting at ``stride``."""

    def __init__(self, in_ch: int, blocks: int, channels: int, stride: int, device=None):
        super().__init__()
        self.add_module("block1", Bottleneck(in_ch, channels, stride, True, device))
        for i in range(1, blocks):
            self.add_module(f"block{i + 1}", Bottleneck(4 * channels, channels, 1, False, device))


class ResNet101C4(nn.Module):
    """conv1 .. res4: (B, H, W, 3) NHWC, H and W multiples of 16 ->
    (B, H/16, W/16, 1024)."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, device=device)
        self.bn1 = FrozenBatchNorm(64, device)
        self.res2 = ResStage(64, 3, 64, 1, device)
        self.res3 = ResStage(256, 4, 128, 2, device)
        self.res4 = ResStage(512, 23, 256, 2, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # channels-last NCHW view
        with torch.no_grad():                          # the frozen stem
            x = frozen_bn(conv(x, self.conv1), self.bn1)
            x = self.res2(max_pool(x))
        x = self.res4(self.res3(x))
        return x.permute(0, 2, 3, 1).contiguous()


class ResNetC5Head(nn.Module):
    """res5 + spatial mean + (cls_score, bbox_pred) on (R, 14, 14, 1024)
    NHWC RoI crops, as K2 writes them."""

    def __init__(self, num_classes: int = 21, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.res5 = ResStage(1024, 3, 512, 2, device)
        self.cls_score = nn.Linear(2048, num_classes, device=device)
        self.bbox_pred = nn.Linear(2048, 4 * num_classes, device=device)

    def forward(self, pooled: torch.Tensor, generator=None, shard=(0, 1)):
        """pooled (R, P, P, 1024) -> (cls_score (R, K), bbox_pred (R, 4K)),
        float32.  ``generator`` and ``shard`` are unused: the head has no
        dropout."""
        y = spatial_mean(self.res5(pooled.to(self.dtype).permute(0, 3, 1, 2))).float()
        return dense(y, self.cls_score), dense(y, self.bbox_pred)
