"""RoIAlign, bilinear and averaged, forward and backward (port of
``trcnn/ops/roi_align.py``, selected by ``RoIConfig.mode="align"``).

Semantics are the JAX package's, not torchvision's:
  x1 = rois[0] * scale (and y1, x2, y2)        continuous, no +1, no shift
  roi_w = max(x2 - x1, 1),  bin_w = roi_w / P  (float32 quotient)
  sample j of the RoI's P*s along x:  x1 + (j + 0.5) / s * bin_w
  each sample clipped to [0, W - 1] BEFORE its floor; lo = floor,
  hi = min(lo + 1, W - 1), fx = x - lo         (torchvision zeroes samples
                                                outside [-1, W] instead)
  value = v00*(1-fy)*(1-fx) + v01*(1-fy)*fx + v10*fy*(1-fx) + v11*fy*fx
  out[p] = the mean of the bin's s x s samples.
The corner values are promoted to float32 (the weights are float32), so the
mean is float32 whatever the feature dtype, and that is the default output
(JAX's contract).  ``out_dtype=torch.bfloat16`` rounds each mean once to
bfloat16, bit-equal to the float32 output cast: the model asks for its
compute dtype, so the heads' cast does nothing and no float32 crop tensor
is made.  :func:`roi_align_plain` keeps the JAX expression's product and
sum order (``roi_align.py:80-85``) and sums a bin's samples row by row
before the division, which kernel K5 repeats without FMA contraction.

Backward: each sample sends g / s^2 times its four bilinear weights to its
four corner cells, accumulated in float32 and rounded once to the feature
dtype.  g comes in the output's dtype (a bfloat16 output's cotangent is
bfloat16, exactly the values its float32 upcast had).  (JAX's bf16 gradient
rounds every corner's cotangent to bf16 and scatter-adds in bf16, so bf16
feature gradients agree with it only loosely.)  The RoIs get no gradient:
the proposals are detached.

``roi_align`` is a ``torch.autograd.Function``: kernels K5
(``csrc/roi_align.cu``) and K6 (``csrc/roi_align_bwd.cu``, tiled by
:func:`_bwd_plan`) for CUDA tensors, the plain versions for CPU tensors.
Both plain versions run in chunks of RoIs, so that the card can replay K5's
and K6's full-width calls through them.  The JAX package runs RoIAlign in
XLA; K5 and K6 are CUDA kernels for that computation, not ports of a
Pallas kernel: at ResNet-101 COCO detect (8 x 1000 RoIs, P=14, 1024
channels) each of the plain formulation's four corner tensors is 25.7 GB in
float32.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from trcnn_torch import _build
from trcnn_torch.ops.boxes import ieee_div
from trcnn_torch.utils import profiling

# RoIs per chunk of the plain versions: at (8 images, P=14, s=2, 1024
# channels) one float32 corner tensor of a chunk is 411 MB
PLAIN_CHUNK = 16
# the kernels keep a RoI's P * s sample positions per axis in shared memory,
# and K6 a bin's 2s cells per axis
MAX_SAMPLES = 64
MAX_SAMPLING = 4


@lru_cache(maxsize=None)
def _grid_np(out_size: int, sampling_ratio: int) -> np.ndarray:
    return ((np.arange(out_size * sampling_ratio, dtype=np.float32) + np.float32(0.5))
            / np.float32(sampling_ratio))


def _axis(start: torch.Tensor, bin_: torch.Tensor, grid: torch.Tensor, size: int):
    """Sample positions along one axis, (..., R) -> (lo, hi, frac), each
    (..., R, P*s): clipped to [0, size - 1], then floored."""
    coord = start[..., None] + grid * bin_[..., None]
    coord = torch.clamp(coord, 0.0, size - 1.0)
    lo = torch.floor(coord)
    frac = coord - lo
    lo = lo.long()
    return lo, torch.clamp(lo + 1, max=size - 1), frac


def _samples(rois: torch.Tensor, out_size: int, spatial_scale: float, sampling_ratio: int,
             h: int, w: int):
    """((y_lo, y_hi, fy), (x_lo, x_hi, fx)) for rois (B, R, 4), each
    (B, R, P*s)."""
    rois = rois.float()
    x1, y1, x2, y2 = (rois[..., i] * spatial_scale for i in range(4))
    bin_w = ieee_div(torch.clamp(x2 - x1, min=1.0), float(out_size))
    bin_h = ieee_div(torch.clamp(y2 - y1, min=1.0), float(out_size))
    grid = torch.from_numpy(_grid_np(out_size, sampling_ratio)).to(rois.device)
    return _axis(y1, bin_h, grid, h), _axis(x1, bin_w, grid, w)


def _chunks(r: int, chunk: int):
    return range(0, r, max(int(chunk), 1))


def roi_align_plain(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
                    spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
                    out_dtype: torch.dtype = torch.float32,
                    chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """feat (B, H, W, C) float32 or bfloat16, rois (B, R, 4) image
    coordinates -> (B, R, P, P, C) float32 means, cast to ``out_dtype``,
    ``chunk`` RoIs at a time."""
    b, h, w, c = feat.shape
    r, s, p = rois.shape[1], sampling_ratio, out_size
    out = torch.empty((b, r, p, p, c), dtype=out_dtype, device=feat.device)
    flat = feat.reshape(b, h * w, c)
    bidx = torch.arange(b, device=feat.device)[:, None, None]
    for i in _chunks(r, chunk):
        (y_lo, y_hi, fy), (x_lo, x_hi, fx) = _samples(rois[:, i:i + chunk], p,
                                                      spatial_scale, s, h, w)
        rc = y_lo.shape[1]

        def gather(hy, hx):             # -> (B, rc, P*s, P*s, C) float32
            lin = (hy[..., :, None] * w + hx[..., None, :]).reshape(b, rc, -1)
            return flat[bidx, lin].reshape(b, rc, p * s, p * s, c).float()

        wy = fy[..., :, None, None]
        wx = fx[..., None, :, None]
        vals = (gather(y_lo, x_lo) * (1 - wy) * (1 - wx)
                + gather(y_lo, x_hi) * (1 - wy) * wx
                + gather(y_hi, x_lo) * wy * (1 - wx)
                + gather(y_hi, x_hi) * wy * wx)
        vals = vals.reshape(b, rc, p, s, p, s, c)
        acc = vals[:, :, :, 0, :, 0]
        for iy in range(s):
            for ix in range(s):
                if iy or ix:
                    acc = acc + vals[:, :, :, iy, :, ix]
        out[:, i:i + rc] = ieee_div(acc, float(s * s))
    return out


def roi_align_backward_plain(feat_shape, feat_dtype, rois: torch.Tensor, g: torch.Tensor,
                             out_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                             sampling_ratio: int = 2, chunk: int = PLAIN_CHUNK
                             ) -> torch.Tensor:
    """rois (B, R, 4), g (B, R, P, P, C) float32 or bfloat16 -> dfeat
    (B, H, W, C) in ``feat_dtype``: each sample's cotangent g / s^2, times
    each corner's weights (in the order of JAX's transpose), index-added
    into a float32 dfeat, ``chunk`` RoIs at a time, then rounded once."""
    b, h, w, c = feat_shape
    r, s, p = rois.shape[1], sampling_ratio, out_size
    dflat = torch.zeros((b * h * w, c), dtype=torch.float32, device=g.device)
    base = (torch.arange(b, device=g.device) * (h * w))[:, None, None, None]
    for i in _chunks(r, chunk):
        (y_lo, y_hi, fy), (x_lo, x_hi, fx) = _samples(rois[:, i:i + chunk], p,
                                                      spatial_scale, s, h, w)
        rc = y_lo.shape[1]
        gb = ieee_div(g[:, i:i + rc].float(), float(s * s))       # (B, rc, P, P, C)
        gs = gb[:, :, :, None, :, None].expand(b, rc, p, s, p, s, c)
        gs = gs.reshape(b, rc, p * s, p * s, c)
        wy = fy[..., :, None, None]
        wx = fx[..., None, :, None]
        for hy, hx, cy, cx in ((y_lo, x_lo, 1 - wy, 1 - wx), (y_lo, x_hi, 1 - wy, wx),
                               (y_hi, x_lo, wy, 1 - wx), (y_hi, x_hi, wy, wx)):
            idx = base + hy[..., :, None] * w + hx[..., None, :]  # (B, rc, P*s, P*s)
            dflat.index_add_(0, idx.reshape(-1), (gs * cx * cy).reshape(-1, c))
    return dflat.reshape(b, h, w, c).to(feat_dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
# K6: its dfeat slab per block (four blocks share an SM beside their RoI
# geometry), its threads per block where the channels allow, its channel
# slice
SLAB_BYTES = 36 * 1024
BWD_THREADS = 256
BWD_MAX_CC = 1024


def _check_rois(what: str, rois: torch.Tensor, b: int, dev: torch.device) -> None:
    """rois: contiguous float32 (b, R, 4) on the CUDA device ``dev``."""
    if dev.type != "cuda" or rois.device != dev:
        raise ValueError(f"{what} needs CUDA tensors on one device, got {dev} and {rois.device}")
    if (rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[0] != b
            or rois.shape[2] != 4 or not rois.is_contiguous()):
        raise ValueError(f"rois must be contiguous float32 (B, R, 4), got "
                         f"{rois.dtype} {tuple(rois.shape)}")


def _check_pool(out_size: int, sampling_ratio: int) -> None:
    if (out_size < 1 or not 1 <= sampling_ratio <= MAX_SAMPLING
            or out_size * sampling_ratio > MAX_SAMPLES):
        raise ValueError(f"the kernels take s <= {MAX_SAMPLING} and P * s <= {MAX_SAMPLES}, "
                         f"got P={out_size}, s={sampling_ratio}")


def _check_dtype(what: str, dtype: torch.dtype) -> None:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"{what} must be float32 or bfloat16, got {dtype}")


def roi_align_cuda(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
                   spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kernel K5: :func:`roi_align_plain` on the card, one block per
    (image, RoI) computing from the cells its samples touch, staged in
    shared memory (read through L1 where they are reused too little)."""
    if feat.dim() != 4 or feat.dtype not in _DTYPE_CODE or not feat.is_contiguous():
        raise ValueError(f"feat must be contiguous float32/bfloat16 (B, H, W, C), "
                         f"got {feat.dtype} {tuple(feat.shape)}")
    _check_dtype("out_dtype", out_dtype)
    _check_rois("roi_align_cuda", rois, feat.shape[0], feat.device)
    _check_pool(out_size, sampling_ratio)
    b, h, w, c = feat.shape
    r = rois.shape[1]
    out = torch.empty((b, r, out_size, out_size, c), dtype=out_dtype, device=feat.device)
    if out.numel() == 0:
        return out
    fn = _build.function("roi_align", "trcnn_roi_align_fwd", _FWD_ARGTYPES)
    err = fn(_build.ptr(feat), _build.ptr(rois), b, r, h, w, c, out_size, sampling_ratio,
             spatial_scale, _DTYPE_CODE[feat.dtype], _DTYPE_CODE[out_dtype], _build.ptr(out),
             _build.stream_of(feat.device))
    _build.check(err, "trcnn_roi_align_fwd")
    profiling.count("launch.roi_align")
    return out


class BwdPlan(NamedTuple):
    """K6's tiling of a map: V channels a thread (4 or 2 on the vector
    path, 1 off it), cc channels and ty x tx cells a block, and its dynamic
    shared memory (the slab) in bytes."""

    v: int
    cc: int
    ty: int
    tx: int
    smem: int


@lru_cache(maxsize=None)
def _bwd_plan(h: int, w: int, c: int, vec: bool) -> BwdPlan:
    """K6's tiling of an h x w map of c channels.  The vector path (c a
    multiple of 8, aligned tensors): slices of up to BWD_MAX_CC channels,
    the narrowest V that needs at most BWD_THREADS threads; off it one
    channel a thread, slices of up to BWD_THREADS.  A tile holds as many cells as
    SLAB_BYTES of float32 slab take, about square (at least one cell), cut
    to the map."""
    if vec:
        cc = min(c, BWD_MAX_CC)
        v = next(v for v in (2, 4) if -(-cc // v) <= BWD_THREADS)
    else:
        cc, v = min(c, BWD_THREADS), 1
    cells = max(1, SLAB_BYTES // (cc * 4))
    side = max(1, math.isqrt(cells))
    tx = min(w, max(1, cells // side))
    ty = min(h, max(1, cells // tx))
    return BwdPlan(v, cc, ty, tx, ty * tx * cc * 4)


def roi_align_backward_cuda(feat_shape, feat_dtype, rois: torch.Tensor, g: torch.Tensor,
                            out_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                            sampling_ratio: int = 2) -> torch.Tensor:
    """Kernel K6: :func:`roi_align_backward_plain` on the card.  One launch
    writes every element of dfeat, allocated here in ``feat_dtype``, from
    float32 sums kept in shared memory (tiling from :func:`_bwd_plan`),
    each element summed by one thread in a fixed order: run to run
    bit-identical."""
    b, h, w, c = feat_shape
    _check_rois("roi_align_backward_cuda", rois, b, g.device)
    r = rois.shape[1]
    if (g.dtype not in _DTYPE_CODE or not g.is_contiguous()
            or tuple(g.shape) != (b, r, out_size, out_size, c)):
        raise ValueError(f"g must be a contiguous float32/bfloat16 {(b, r, out_size, out_size, c)} "
                         f"tensor, got {g.dtype} {tuple(g.shape)}")
    _check_dtype("feat_dtype", feat_dtype)
    _check_pool(out_size, sampling_ratio)
    dfeat = torch.empty(feat_shape, dtype=feat_dtype, device=g.device)
    if dfeat.numel() == 0:
        return dfeat
    plan = _bwd_plan(h, w, c, c % 8 == 0 and g.data_ptr() % 16 == 0)
    fn = _build.function("roi_align_bwd", "trcnn_roi_align_bwd", _BWD_ARGTYPES)
    err = fn(_build.ptr(g), _build.ptr(rois), b, r, h, w, c, out_size, sampling_ratio,
             spatial_scale, _DTYPE_CODE[g.dtype], _DTYPE_CODE[feat_dtype], plan.v, plan.cc,
             plan.ty, plan.tx, plan.smem, _build.ptr(dfeat), _build.stream_of(g.device))
    _build.check(err, "trcnn_roi_align_bwd")
    profiling.count("launch.roi_align_bwd")
    return dfeat


class _RoIAlign(torch.autograd.Function):
    """K5 / plain forward, K6 / plain backward; no gradient to the RoIs."""

    @staticmethod
    def forward(ctx, feat, rois, out_size, spatial_scale, sampling_ratio, out_dtype):
        ctx.save_for_backward(rois)
        ctx.feat = (tuple(feat.shape), feat.dtype)
        ctx.pool = (out_size, spatial_scale, sampling_ratio)
        fwd = roi_align_cuda if feat.device.type == "cuda" else roi_align_plain
        return fwd(feat, rois, *ctx.pool, out_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (rois,) = ctx.saved_tensors
        bwd = roi_align_backward_cuda if g.device.type == "cuda" else roi_align_backward_plain
        return bwd(*ctx.feat, rois, g.contiguous(), *ctx.pool), None, None, None, None, None


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """RoIAlign over a batch: feat (B, H, W, C) NHWC, rois (B, R, 4) ->
    (B, R, out, out, C) in ``out_dtype`` (float32 means, or those means
    rounded once to bfloat16), differentiable in feat.  Kernels K5
    (forward) and K6 (backward) for CUDA tensors, the plain versions for
    CPU."""
    if feat.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RoIAlign for device {feat.device}")
    return _RoIAlign.apply(feat, rois, out_size, spatial_scale, sampling_ratio, out_dtype)
