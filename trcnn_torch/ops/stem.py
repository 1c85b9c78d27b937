"""The VGG stem: conv1_1 -> ReLU -> conv1_2 -> ReLU -> 2x2/2 max pool
(port of ``trcnn/ops/stem_pallas.py``).

Numerics are those of ``stem_block1_reference``: each convolution
accumulates in float32, its output is rounded to the compute dtype (the
input's), and bias + ReLU run in that dtype.

``stem_block1`` launches kernel K3 (``csrc/stem.cu``, conv1_1's output never
reaches device memory) on CUDA tensors and runs :func:`stem_block1_plain` on
CPU tensors.  The stem is forward only, as the frozen-stem recipe has it.

Layouts: ``x`` is NHWC (B, H, W, 3) in the compute dtype, H and W even; the
weights are ``nn.Conv2d``'s OIHW, the biases (C,).  Output (B, H/2, W/2, 64).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from trcnn_torch import _build
from trcnn_torch.utils import profiling


def _conv_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NCHW 3x3 SAME conv in x.dtype, then bias + ReLU in x.dtype."""
    y = F.conv2d(x, w.to(x.dtype), padding=1)
    return torch.relu(y + b.to(x.dtype).view(1, -1, 1, 1))


def stem_block1_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    y = x.permute(0, 3, 1, 2)                       # channels-last NCHW view
    y = _conv_bias_relu(_conv_bias_relu(y, w1, b1), w2, b2)
    return F.max_pool2d(y, 2, 2).permute(0, 2, 3, 1).contiguous()


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_C = 64


def stem_block1_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Kernel K3: :func:`stem_block1_plain` on the card."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (w1, b1, w2, b2)):
        raise ValueError("stem_block1_cuda needs CUDA tensors on one device")
    if (x.dim() != 4 or x.shape[3] != 3 or x.dtype not in _DTYPE_CODE
            or not x.is_contiguous()):
        raise ValueError(f"x must be contiguous float32/bfloat16 (B, H, W, 3), "
                         f"got {x.dtype} {tuple(x.shape)}")
    bsz, h, w, _ = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"stem needs an even canvas, got {h}x{w}")
    if (w1.shape != (_C, 3, 3, 3) or w2.shape != (_C, _C, 3, 3)
            or b1.shape != (_C,) or b2.shape != (_C,)):
        raise ValueError("stem weights must be conv1_1 (64, 3, 3, 3) and "
                         "conv1_2 (64, 64, 3, 3) OIHW with (64,) biases")
    dt = x.dtype
    # HWIO, contiguous over output channels: the kernel's weight layout
    w1k = w1.to(dt).permute(2, 3, 1, 0).contiguous()
    w2k = w2.to(dt).permute(2, 3, 1, 0).contiguous()
    b1k, b2k = b1.to(dt).contiguous(), b2.to(dt).contiguous()
    out = torch.empty((bsz, h // 2, w // 2, _C), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function("stem", "trcnn_stem_fwd", _ARGTYPES)
    err = fn(_build.ptr(x), _build.ptr(w1k), _build.ptr(b1k), _build.ptr(w2k),
             _build.ptr(b2k), bsz, h, w, _DTYPE_CODE[dt], _build.ptr(out),
             _build.stream_of(dev))
    _build.check(err, "trcnn_stem_fwd")
    profiling.count("launch.stem")
    return out


def stem_block1(x, w1, b1, w2, b2):
    """Fused stem: kernel K3 for CUDA tensors, plain for CPU."""
    if x.device.type == "cuda":
        return stem_block1_cuda(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return stem_block1_plain(x, w1, b1, w2, b2)
    raise ValueError(f"no stem for device {x.device}")
