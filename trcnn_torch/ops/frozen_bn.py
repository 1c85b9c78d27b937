"""ResNet-101's FrozenBN epilogue: the frozen affine, the residual add and
the ReLU of a bottleneck in one pass (kernel K7, ``csrc/frozen_bn.cu``).

A FrozenBN folds its four float32 leaves into one multiply and one add:
  std = sqrt(var + eps),  inv = scale / std,  shift = bias - mean * inv
in float32, then ``inv`` and ``shift`` are each rounded to x's dtype and
  y = (x * inv) + shift          each operation rounded to x's dtype
(flax's order, ``trcnn/models/resnet.py:46-48``; folding the BN into the
convolution would round differently in bf16).  The bottleneck's epilogues
are three forms of it, each followed by the ReLU:
  relu(bn(x))                    bn1 and bn2 of every block, the stem's bn1
  relu(bn(x) + residual)         bn3 of an identity block, the add rounded
  relu(bn(x) + bn_p(p))          bn3 of a projecting block; bn_p is its
                                 shortcut's FrozenBN (proj_bn) on p
and ``relu=False`` gives the bare affine (``FrozenBatchNorm.forward``).

:func:`frozen_bn` is the one autograd node of an epilogue:
:func:`frozen_bn_plain` (the same operations in PyTorch) for CPU tensors,
K7 for any other (a tensor K7 cannot take raises).  K7 replaces no TPU
kernel: XLA fuses these elementwise operations into one pass after each
convolution, where eager PyTorch ran about ten passes a bottleneck over the
convolutions' outputs (the fold's small launches, the multiply, the add,
the ReLUs, the residual add), which took most of R101 detect's device
time.  Backward is plain PyTorch: the ReLU's
mask from the saved output (as ``threshold_backward`` takes it), the
masked gradient passed to the residual, dx = g * inv in x's dtype, and the
leaves' gradients from two per-channel float32 sums, sum(g) and sum(g * x)
(the product rounded to x's dtype, as autograd's is), through the fold's
chain rule in float32, the fold recomputed there.  It saves what the
unfused graph kept: the convolution output only where the leaves take
gradients, and the output for the ReLU's mask, which a node of its own
applies, as the unfused graph's ReLU did, so that a backward holds no more
gradient-sized tensors at once than the unfused one.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from trcnn_torch import _build
from trcnn_torch.utils import profiling

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_void_p] * 4
             + [ctypes.c_float, ctypes.c_longlong] + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_void_p])


def _inv(scale: torch.Tensor, var: torch.Tensor, eps: float):
    """(inv, std) in float32."""
    std = torch.sqrt(var + eps)
    return scale / std, std


def affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
           var: torch.Tensor, eps: float) -> torch.Tensor:
    """bn(x) on NCHW: the fold in float32, then the multiply and the add
    each rounded to x's dtype."""
    inv, _ = _inv(scale, var, eps)
    shift = bias - mean * inv
    return x * inv.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


def frozen_bn_plain(x, scale, bias, mean, var, eps, residual=None, p=None, p_scale=None,
                    p_bias=None, p_mean=None, p_var=None, p_eps=None, relu=True):
    """The epilogue in PyTorch operations: bn(x), plus ``residual`` or plus
    the FrozenBN of the ``p_*`` leaves on ``p``, then the ReLU."""
    y = affine(x, scale, bias, mean, var, eps)
    if p is not None:
        y = y + affine(p, p_scale, p_bias, p_mean, p_var, p_eps)
    elif residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_side(what: str, t: torch.Tensor, x: torch.Tensor) -> None:
    if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
        raise ValueError(f"{what} must match x ({x.dtype} {tuple(x.shape)} on {x.device}), "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16:
        raise ValueError(f"{what} must be a 16-byte aligned channels-last dense tensor")


def _check_leaves(what: str, leaves, c: int, dev: torch.device) -> None:
    for t in leaves:
        if (t.dtype != torch.float32 or t.shape != (c,) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{what} leaves must be contiguous float32 ({c},) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def frozen_bn_cuda(x, scale, bias, mean, var, eps, residual=None, p=None, p_scale=None,
                   p_bias=None, p_mean=None, p_var=None, p_eps=None, relu=True):
    """Kernel K7: :func:`frozen_bn_plain` on the card, one launch.  x (and
    ``residual`` or ``p``): float32 or bfloat16 NCHW, channels-last dense,
    C a multiple of 8; without the ReLU only the bare affine."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"frozen_bn_cuda needs CUDA tensors, got {dev}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32/bfloat16 NCHW, got {x.dtype} {tuple(x.shape)}")
    c = x.shape[1]
    if c % 8:
        raise ValueError(f"K7 takes channels in multiples of 8, got {c}")
    _check_side("x", x, x)
    _check_leaves("the FrozenBN", (scale, bias, mean, var), c, dev)
    if p is not None:
        if residual is not None:
            raise ValueError("give a residual or a projection, not both")
        _check_side("p", p, x)
        _check_leaves("the projection's FrozenBN", (p_scale, p_bias, p_mean, p_var), c, dev)
        form, side = 2, p
    elif residual is not None:
        _check_side("residual", residual, x)
        form, side = 1, residual
    else:
        form, side = 0, None
    if form and not relu:
        raise ValueError("K7 applies the ReLU after a residual or a projection")
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    none = ctypes.c_void_p(None)
    ptr = lambda t: none if t is None else _build.ptr(t)  # noqa: E731
    fn = _build.function("frozen_bn", "trcnn_frozen_bn", _ARGTYPES)
    err = fn(_build.ptr(x), ptr(side), _build.ptr(scale), _build.ptr(bias), _build.ptr(mean),
             _build.ptr(var), eps, ptr(p_scale), ptr(p_bias), ptr(p_mean), ptr(p_var),
             eps if p_eps is None else p_eps, x.numel() // c, c, _DTYPE_CODE[x.dtype], form,
             int(relu), _sms(dev.index if dev.index is not None else torch.cuda.current_device()),
             _build.ptr(out), _build.stream_of(dev))
    _build.check(err, "trcnn_frozen_bn")
    profiling.count("launch.frozen_bn")
    return out


def _leaf_grads(g, x, scale, mean, inv, std):
    """The four leaves' gradients (scale, bias, mean, var) in float32 from
    sum(g) and sum(g * x)."""
    d_shift = g.sum((0, 2, 3), dtype=torch.float32)
    d_inv = (g * x).sum((0, 2, 3), dtype=torch.float32) - mean * d_shift
    return d_inv / std, d_shift, -inv * d_shift, -d_inv * scale / (std * std) / (2 * std)


class _FrozenBNEpilogue(torch.autograd.Function):
    """The epilogue's node: inputs x, residual, p, the four leaves, p's four
    leaves, eps, p_eps, relu.  Its backward takes the gradient already
    masked by the ReLU (:class:`_ReLUMask`)."""

    @staticmethod
    def forward(ctx, x, residual, p, scale, bias, mean, var, p_scale, p_bias, p_mean, p_var,
                eps, p_eps, relu):
        run = frozen_bn_plain if x.device.type == "cpu" else frozen_bn_cuda
        out = run(x, scale, bias, mean, var, eps, residual, p, p_scale, p_bias, p_mean, p_var,
                  p_eps, relu)
        need = ctx.needs_input_grad
        ctx.eps, ctx.p_eps = eps, p_eps
        ctx.save_for_backward(x if any(need[3:7]) else None, p if any(need[7:11]) else None,
                              scale, mean, var, p_scale, p_mean, p_var)
        return out

    @staticmethod
    def backward(ctx, g):
        x, p, scale, mean, var, p_scale, p_mean, p_var = ctx.saved_tensors
        need = ctx.needs_input_grad
        # every leaf sum before dx and dp, so that no g * x product is alive
        # beside them
        inv, std = _inv(scale, var, ctx.eps)
        leaves = (None,) * 4 if x is None else _leaf_grads(g, x, scale, mean, inv, std)
        p_leaves, dp = (None,) * 4, None
        if p_scale is not None:
            p_inv, p_std = _inv(p_scale, p_var, ctx.p_eps)
            if p is not None:
                p_leaves = _leaf_grads(g, p, p_scale, p_mean, p_inv, p_std)
            if need[2]:
                dp = g * p_inv.to(g.dtype).view(1, -1, 1, 1)
        dx = g * inv.to(g.dtype).view(1, -1, 1, 1) if need[0] else None
        return (dx, g if need[1] else None, dp, *leaves, *p_leaves, None, None, None)


class _ReLUMask(torch.autograd.Function):
    """The epilogue's ReLU as a node of its own: forward passes the
    epilogue's (already rectified) output through; backward masks the
    gradient by it, as ``threshold_backward`` does.  A node apart from the
    epilogue's, so that the engine frees the incoming gradient before the
    FrozenBN's backward makes dx, as behind the unfused graph's ReLU."""

    @staticmethod
    def forward(ctx, out):
        ctx.save_for_backward(out)
        # an alias with out's own strides (autograd's view of an input
        # returned as is may restride a dimension of size 1, and with it the
        # memory format the next convolution picks)
        return out.as_strided(out.shape, out.stride())

    @staticmethod
    def backward(ctx, g):
        return torch.ops.aten.threshold_backward(g, ctx.saved_tensors[0], 0)


def frozen_bn(x: torch.Tensor, bn, residual: torch.Tensor | None = None, proj=None,
              relu: bool = True) -> torch.Tensor:
    """The epilogue of ``bn`` (a ``FrozenBatchNorm``: its ``scale``,
    ``bias``, ``mean``, ``var`` and ``eps``) on NCHW x: relu(bn(x)), with
    ``residual`` relu(bn(x) + residual), with ``proj=(p, bn_p)``
    relu(bn(x) + bn_p(p)); ``relu=False`` leaves the ReLU out."""
    p, bn_p = proj if proj is not None else (None, None)
    p_leaves = ((bn_p.scale, bn_p.bias, bn_p.mean, bn_p.var) if bn_p is not None
                else (None,) * 4)
    out = _FrozenBNEpilogue.apply(x, residual, p, bn.scale, bn.bias, bn.mean, bn.var,
                                  *p_leaves, bn.eps, None if bn_p is None else bn_p.eps, relu)
    return _ReLUMask.apply(out) if relu and out.requires_grad else out
