"""RoI max pooling, Caffe/Chainer ``roi_pooling_2d``, forward and backward
(port of ``trcnn/ops/roi_pool.py``).

Bin bounds:
  roi_start = round(coord * spatial_scale)        (half away from zero)
  roi_size  = max(roi_end - roi_start + 1, 1)
  bin       = f32(roi_size) / f32(out)             (IEEE quotient)
  bin [p]   = [floor(p * bin), ceil((p+1) * bin)) + roi_start, clipped
  empty bins give 0.
The IEEE quotient decides ``ceil`` at exact multiples (roi_size=57, out=7:
fl(57/7)*7 = 57.000004 -> 58), so the plain version reads it from the same
host-computed float32 table as the JAX code, and kernels K2 and K4 divide
with ``__fdiv_rn`` (``csrc/roi_bins.cuh``, shared by both).

Backward: each non-empty bin routes its whole gradient to ONE argmax cell
per channel, the one with the smallest column-major key ``x*H + y`` among
equal maxima, accumulated in float32 (the JAX package's single-winner
contract).  Autograd through a max would split the gradient evenly among
tied cells, and ReLU zeros tie all the time, so :func:`roi_max_pool` is a
``torch.autograd.Function`` whose forward runs without autograd and whose
backward is written out: :func:`roi_pool_backward_plain`, or kernel K4
(``csrc/roi_pool_bwd.cu``) on the card.

``roi_max_pool`` launches K2 / K4 on CUDA tensors and runs the plain
versions on CPU tensors.  A max is a selection, so K2 is bit-equal to its
plain version; K4 adds in float32 atomics, bit-equal on integer-valued
gradients and within rounding otherwise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from trcnn_torch import _build

# roi sizes index a table of this length (trcnn/ops/roi_pool.py:58); the
# kernel clamps the same way
DIV_TABLE_MAX = 4096


@lru_cache(maxsize=None)
def _f32_div_table_np(out_size: int) -> np.ndarray:
    return np.arange(DIV_TABLE_MAX, dtype=np.float32) / np.float32(out_size)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def roi_bin_bounds(rois: torch.Tensor, spatial_scale: float, out_size: int,
                   feat_h: int, feat_w: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hstart, hend, wstart, wend), each (..., R, out) int32, clipped to the
    feature extent; ends are exclusive."""
    rois = rois.float()
    start_w = _round_half_away(rois[..., 0] * spatial_scale).to(torch.int32)
    start_h = _round_half_away(rois[..., 1] * spatial_scale).to(torch.int32)
    end_w = _round_half_away(rois[..., 2] * spatial_scale).to(torch.int32)
    end_h = _round_half_away(rois[..., 3] * spatial_scale).to(torch.int32)
    roi_w = torch.clamp(end_w - start_w + 1, min=1)
    roi_h = torch.clamp(end_h - start_h + 1, min=1)
    table = torch.from_numpy(_f32_div_table_np(out_size)).to(rois.device)
    bin_h = table[roi_h.clamp(0, DIV_TABLE_MAX - 1).long()]
    bin_w = table[roi_w.clamp(0, DIV_TABLE_MAX - 1).long()]
    p = torch.arange(out_size, dtype=torch.float32, device=rois.device)

    def edges(bin_, start, extent):
        lo = torch.floor(p * bin_[..., None]).to(torch.int32) + start[..., None]
        hi = torch.ceil((p + 1.0) * bin_[..., None]).to(torch.int32) + start[..., None]
        return lo.clamp(0, extent), hi.clamp(0, extent)

    hstart, hend = edges(bin_h, start_h, feat_h)
    wstart, wend = edges(bin_w, start_w, feat_w)
    return hstart, hend, wstart, wend


def _bin_windows(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
                 spatial_scale: float):
    """Yield (ph, pw, vals, ok, yy, xx) for every bin: its cells gathered
    into a window as large as the largest bin, vals (B, R, M, C) in feat's
    dtype with -inf past the bin's end, ok (B, R, M) the in-bin mask, yy
    and xx (B, R, M) the cells' rows and columns.  One bin at a time keeps
    the gathered block at (B, R, M, C).  The JAX code sizes the window
    statically (``max_bin_extent``), which covers RoIs up to the map's
    size, as proposals clipped to the image are; sized from the bounds, the
    window also covers larger RoIs exactly, as the kernels and the numpy
    oracles do."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    hstart, hend, wstart, wend = roi_bin_bounds(rois, spatial_scale, out_size, h, w)
    mbh = max(int((hend - hstart).amax()), 1) if hend.numel() else 1
    mbw = max(int((wend - wstart).amax()), 1) if wend.numel() else 1
    flat = feat.reshape(b, h * w, c)
    bidx = torch.arange(b, device=feat.device)[:, None, None]
    dh = torch.arange(mbh, dtype=torch.int32, device=feat.device)
    dw = torch.arange(mbw, dtype=torch.int32, device=feat.device)
    for ph in range(out_size):
        h_idx = hstart[..., ph, None] + dh                    # (B, R, MBH)
        h_ok = h_idx < hend[..., ph, None]
        h_idx = h_idx.clamp(0, h - 1)
        for pw in range(out_size):
            w_idx = wstart[..., pw, None] + dw                # (B, R, MBW)
            w_ok = w_idx < wend[..., pw, None]
            w_idx = w_idx.clamp(0, w - 1)
            yy = h_idx[..., :, None].expand(b, r, mbh, mbw).reshape(b, r, -1)
            xx = w_idx[..., None, :].expand(b, r, mbh, mbw).reshape(b, r, -1)
            ok = (h_ok[..., :, None] & w_ok[..., None, :]).reshape(b, r, -1)
            vals = flat[bidx, (yy * w + xx).long()]           # (B, R, M, C)
            yield ph, pw, torch.where(ok[..., None], vals, float("-inf")), ok, yy, xx


def roi_max_pool_plain(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
                       spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """feat (B, H, W, C), rois (B, R, 4) image coords -> (B, R, P, P, C):
    each bin's window reduced with max, empty bins 0."""
    b, _, _, c = feat.shape
    out = feat.new_empty((b, rois.shape[1], out_size, out_size, c))
    for ph, pw, vals, ok, _, _ in _bin_windows(feat, rois, out_size, spatial_scale):
        out[:, :, ph, pw] = torch.where(~ok.any(dim=2)[..., None], 0.0, vals.amax(dim=2))
    return out


def roi_pool_backward_plain(feat: torch.Tensor, rois: torch.Tensor, g: torch.Tensor,
                            out_size: int = 7, spatial_scale: float = 1.0 / 16.0
                            ) -> torch.Tensor:
    """feat (B, H, W, C), rois (B, R, 4), g (B, R, P, P, C) -> dfeat
    (B, H, W, C) in feat's dtype.

    Per bin: the max over the window's cells, and among the cells equal to
    it the smallest column-major key ``x*H + y``; a non-empty bin adds its
    g (as float32) to that cell of a float32 dfeat.
    """
    b, h, w, c = feat.shape
    dflat = torch.zeros((b, h * w, c), dtype=torch.float32, device=feat.device)
    big = h * w + 1
    for ph, pw, vals, ok, yy, xx in _bin_windows(feat, rois, out_size, spatial_scale):
        vals = vals.float()
        hit = ok[..., None] & (vals == vals.amax(dim=2, keepdim=True))
        key = (xx * h + yy)[..., None].long()                 # column-major
        kmin = torch.where(hit, key, big).amin(dim=2)         # (B, R, C)
        nonempty = kmin < big
        cell = torch.where(nonempty, (kmin % h) * w + kmin // h, 0)
        contrib = torch.where(nonempty, g[:, :, ph, pw].float(), 0.0)
        dflat.scatter_add_(1, cell, contrib)
    return dflat.reshape(b, h, w, c).to(feat.dtype)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_inputs(what: str, feat: torch.Tensor, rois: torch.Tensor) -> None:
    dev = feat.device
    if dev.type != "cuda" or rois.device != dev:
        raise ValueError(f"{what} needs CUDA tensors on one device, "
                         f"got {dev} and {rois.device}")
    if feat.dim() != 4 or feat.dtype not in _DTYPE_CODE or not feat.is_contiguous():
        raise ValueError(f"feat must be contiguous float32/bfloat16 (B, H, W, C), "
                         f"got {feat.dtype} {tuple(feat.shape)}")
    if (rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[0] != feat.shape[0]
            or rois.shape[2] != 4 or not rois.is_contiguous()):
        raise ValueError(f"rois must be contiguous float32 (B, R, 4), got "
                         f"{rois.dtype} {tuple(rois.shape)}")


def roi_max_pool_cuda(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
                      spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Kernel K2: :func:`roi_max_pool_plain` on the card."""
    _check_inputs("roi_max_pool_cuda", feat, rois)
    dev = feat.device
    b, h, w, c = feat.shape
    r = rois.shape[1]
    out = torch.empty((b, r, out_size, out_size, c), dtype=feat.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function("roi_pool", "trcnn_roi_pool_fwd", _ARGTYPES)
    err = fn(_build.ptr(feat), _build.ptr(rois), b, r, h, w, c, out_size,
             spatial_scale, _DTYPE_CODE[feat.dtype], _build.ptr(out),
             _build.stream_of(dev))
    _build.check(err, "trcnn_roi_pool_fwd")
    _build.count_launch("roi_pool")
    return out


_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def roi_pool_backward_cuda(feat: torch.Tensor, rois: torch.Tensor, g: torch.Tensor,
                           out_size: int = 7, spatial_scale: float = 1.0 / 16.0
                           ) -> torch.Tensor:
    """Kernel K4: :func:`roi_pool_backward_plain` on the card."""
    _check_inputs("roi_pool_backward_cuda", feat, rois)
    b, h, w, c = feat.shape
    r = rois.shape[1]
    if (g.dtype != feat.dtype or g.device != feat.device or not g.is_contiguous()
            or tuple(g.shape) != (b, r, out_size, out_size, c)):
        raise ValueError(f"g must be a contiguous {feat.dtype} {(b, r, out_size, out_size, c)} "
                         f"tensor on {feat.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    dfeat = torch.zeros((b, h, w, c), dtype=torch.float32, device=feat.device)
    if g.numel() == 0 or dfeat.numel() == 0:
        return dfeat.to(feat.dtype)
    fn = _build.function("roi_pool_bwd", "trcnn_roi_pool_bwd", _BWD_ARGTYPES)
    err = fn(_build.ptr(feat), _build.ptr(rois), _build.ptr(g), b, r, h, w, c, out_size,
             spatial_scale, _DTYPE_CODE[feat.dtype], _build.ptr(dfeat),
             _build.stream_of(feat.device))
    _build.check(err, "trcnn_roi_pool_bwd")
    _build.count_launch("roi_pool_bwd")
    return dfeat.to(feat.dtype)


class _RoIMaxPool(torch.autograd.Function):
    """K2 / plain forward, K4 / plain single-winner backward; no gradient
    to the RoIs."""

    @staticmethod
    def forward(ctx, feat, rois, out_size, spatial_scale):
        ctx.save_for_backward(feat, rois)
        ctx.pool = (out_size, spatial_scale)
        if feat.device.type == "cuda":
            return roi_max_pool_cuda(feat, rois, out_size, spatial_scale)
        return roi_max_pool_plain(feat, rois, out_size, spatial_scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        feat, rois = ctx.saved_tensors
        bwd = roi_pool_backward_cuda if feat.device.type == "cuda" else roi_pool_backward_plain
        return bwd(feat, rois, g.contiguous(), *ctx.pool), None, None, None


def roi_max_pool(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
                 spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """RoI max pool over a batch: feat (B, H, W, C) NHWC, rois (B, R, 4)
    -> (B, R, out, out, C), differentiable in feat.  Kernels K2 (forward)
    and K4 (backward) for CUDA tensors, the plain versions for CPU."""
    if feat.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RoI pool for device {feat.device}")
    return _RoIMaxPool.apply(feat, rois, out_size, spatial_scale)
