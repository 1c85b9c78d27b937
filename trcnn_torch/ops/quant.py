"""Dynamic int8 post-training quantization for inference (port of
``trcnn/ops/quant.py``, ``make_model(..., quant="int8")``).

The scheme is the JAX package's:
  * activations: symmetric per-tensor int8 with a max-abs scale taken over
    the whole batch tensor, so a request and a batch of 8 can quantize the
    same image differently;
  * weights: symmetric per-output-channel int8 from the unchanged float32
    parameters (the parameter tree is the float model's);
  * scale = max(amax, 1e-12) / 127 as a float32 quotient, codes =
    clip(round(x / scale), -127, 127) with round half to even;
  * the int8 x int8 products accumulate exactly in int32, then
    y * (sx * sw) (the scale product formed first) + bias, all float32;
    the caller casts to the compute dtype after the bias (the float layers
    round the product first and add the bias in the compute dtype).

The port's ``nn.Conv2d`` weight is OIHW and its ``nn.Linear`` weight
(F, D); :func:`quantize_channels` reduces every axis but the output one,
which gives JAX's per-output scales for its HWIO and (D, F) kernels.

The products run as ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card,
exact in int32) on an im2col of the quantized activation in (kh, kw, cin)
order, built from shifted slices of the padded int8 tensor (``F.unfold``
has no int8 kernel).  The JAX package leaves them to XLA, outside any
Pallas kernel.  Gradients do not flow through ``round``: the mode is
inference-only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trcnn_torch.ops.boxes import ieee_div

_EPS = 1e-12


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q, scale) with x ~ q * scale, scale a
    float32 0-dim tensor on x's device."""
    xf = x.float()
    scale = ieee_div(torch.clamp(xf.abs().amax(), min=_EPS), 127.0)
    return _codes(xf, scale), scale


def quantize_channels(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 along ``axis`` (the output channels):
    (q in w's layout, scale (w.shape[axis],) float32)."""
    wf = w.float()
    dims = tuple(i for i in range(w.dim()) if i != axis)
    scale = ieee_div(torch.clamp(wf.abs().amax(dim=dims, keepdim=True), min=_EPS), 127.0)
    return _codes(wf, scale), scale.reshape(w.shape[axis])


def weight_codes(layer: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Conv2d's or Linear's weight quantized per output channel: (codes
    (N, K) int8, rows in (kh, kw, cin) order for a convolution, scales (N,)
    float32).  Cached on the layer, keyed by the weight's storage, version
    counter, dtype and device: an in-place update (``load_state_dict``, an
    optimizer step) or a new ``.data`` recomputes it, and the cached values
    are the ones recomputing would give."""
    w = layer.weight
    key = (w.data_ptr(), w._version, w.dtype, w.device)
    cached = getattr(layer, "_int8_codes", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            q, scale = quantize_channels(w, axis=0)
            if q.dim() == 4:                                   # OIHW -> O, (kh, kw, I)
                q = q.permute(0, 2, 3, 1)
            cached = (key, q.reshape(q.shape[0], -1).contiguous(), scale)
        layer._int8_codes = cached
    return cached[1], cached[2]


def int8_matmul(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b_nk (N, K) int8 transposed -> (M, N) int32, exact.
    On the card cuBLASLt takes M > 16 and K, N multiples of 8: smaller
    operands are padded with zeros, which add nothing."""
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no int8 product for device {a.device}")
    m, k = a.shape
    n = b_nk.shape[0]
    if a.device.type == "cuda":
        pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
        if pm or pk or pn:
            a = F.pad(a, (0, pk, 0, pm))
            b_nk = F.pad(b_nk, (0, pk, 0, pn))
            return torch._int_mm(a, b_nk.t())[:m, :n]
    return torch._int_mm(a.contiguous(), b_nk.t())


def im2col(xq: torch.Tensor, kh: int, kw: int, pad: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B * H' * W', kh * kw * C) patches of a stride-1
    convolution with zero padding ``pad`` (rows, columns), in (kh, kw, c)
    order, from shifted slices of the padded tensor (any dtype)."""
    b, h, w, c = xq.shape
    xp = F.pad(xq, (0, 0, pad[1], pad[1], pad[0], pad[0]))
    ho, wo = h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1
    cols = torch.cat([xp[:, dy:dy + ho, dx:dx + wo] for dy in range(kh) for dx in range(kw)],
                     dim=-1)
    return cols.reshape(b * ho * wo, kh * kw * c)


def _dequant(y: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    out = y.float() * (sx * sw)
    return out if bias is None else out + bias.float()


def qconv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """int8 x int8 -> int32 stride-1 convolution of NHWC ``x`` by ``conv``
    (its padding, no dilation or groups), dequantized with its bias:
    (B, H', W', out) float32."""
    if conv.stride != (1, 1) or conv.dilation != (1, 1) or conv.groups != 1:
        raise ValueError("qconv2d takes stride-1, undilated, ungrouped convolutions")
    xq, sx = quantize_tensor(x)
    wq, sw = weight_codes(conv)
    kh, kw = conv.kernel_size
    b, h, w, _ = x.shape
    cols = im2col(xq, kh, kw, conv.padding)
    y = int8_matmul(cols, wq)
    ho, wo = h + 2 * conv.padding[0] - kh + 1, w + 2 * conv.padding[1] - kw + 1
    return _dequant(y, sx, sw, conv.bias).reshape(b, ho, wo, -1)


def qdense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """int8 x int8 -> int32 product (R, D) @ W.T, dequantized with the
    bias: (R, F) float32."""
    xq, sx = quantize_tensor(x)
    wq, sw = weight_codes(layer)
    return _dequant(int8_matmul(xq, wq), sx, sw, layer.bias)
