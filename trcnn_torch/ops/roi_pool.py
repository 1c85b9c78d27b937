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
versions on CPU tensors.  K2 (``csrc/roi_pool.cu``) gives each (image,
RoI) one block that writes the RoI's bins in 16-byte channel vectors; a max
is a selection, so it is bit-equal to its plain version.  K4 gives each
(image, channel slice, row band) one block that accumulates the band's
float32 dfeat in shared memory and writes it once in feat's dtype, so the
wrapper allocates the output alone: no float32 scratch, no zeroing, no cast.
The slice width and band height are :func:`_bwd_plan`'s.  A map whose
slice does not fit in shared memory, or with more than 255 cells on a
side, takes K4's large-map variant (``trcnn_roi_pool_bwd_large``, counted
as ``roi_pool_bwd_large``): the same blocks walking feat from global
memory, with 16-bit cell coordinates.  K4's shared-memory atomics add in a
run-dependent order: bit-equal on integer-valued gradients, within
rounding otherwise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from trcnn_torch import _build
from trcnn_torch.utils import profiling

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


# RoIs per window group of the plain versions
ROI_CHUNK = 256


def _bin_windows(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
                 spatial_scale: float):
    """Yield (idx, ph, pw, vals, ok, yy, xx) for every group of RoIs and
    every bin: idx (n,) the group's RoIs as flat (image, RoI) indices into
    (B * R); the bin's cells gathered into a window as large as the
    group's largest bin, vals (n, M, C) in feat's dtype with -inf past the
    bin's end, ok (n, M) the in-bin mask, yy and xx (n, M) the cells' rows
    and columns.  The RoIs go in groups of ``ROI_CHUNK``, in the order of
    their largest bin's area, so that a window sized for the largest bin
    of all does not make every small RoI gather mostly padding; one bin at
    a time keeps the gathered block at (n, M, C).  The JAX code sizes the
    window statically (``max_bin_extent``), which covers RoIs up to the
    map's size, as proposals clipped to the image are; sized from the
    bounds, the window also covers larger RoIs exactly, as the kernels and
    the numpy oracles do."""
    b, h, w, c = feat.shape
    n_rois = b * rois.shape[1]
    bounds = roi_bin_bounds(rois, spatial_scale, out_size, h, w)
    hstart, hend, wstart, wend = (t.reshape(n_rois, out_size) for t in bounds)
    ext_h = (hend - hstart).amax(-1).clamp(min=1)
    ext_w = (wend - wstart).amax(-1).clamp(min=1)
    order = torch.argsort(ext_h * ext_w, stable=True)
    base = torch.arange(b, device=feat.device).repeat_interleave(rois.shape[1]) * (h * w)
    flat = feat.reshape(b * h * w, c)
    for lo in range(0, n_rois, ROI_CHUNK):
        idx = order[lo:lo + ROI_CHUNK]
        n = idx.numel()
        mbh, mbw = int(ext_h[idx].max()), int(ext_w[idx].max())
        dh = torch.arange(mbh, dtype=torch.int32, device=feat.device)
        dw = torch.arange(mbw, dtype=torch.int32, device=feat.device)
        for ph in range(out_size):
            h_idx = hstart[idx, ph, None] + dh                # (n, MBH)
            h_ok = h_idx < hend[idx, ph, None]
            h_idx = h_idx.clamp(0, h - 1)
            for pw in range(out_size):
                w_idx = wstart[idx, pw, None] + dw            # (n, MBW)
                w_ok = w_idx < wend[idx, pw, None]
                w_idx = w_idx.clamp(0, w - 1)
                yy = h_idx[:, :, None].expand(n, mbh, mbw).reshape(n, -1)
                xx = w_idx[:, None, :].expand(n, mbh, mbw).reshape(n, -1)
                ok = (h_ok[:, :, None] & w_ok[:, None, :]).reshape(n, -1)
                vals = flat[base[idx, None] + (yy * w + xx).long()]   # (n, M, C)
                yield idx, ph, pw, torch.where(ok[..., None], vals, float("-inf")), ok, yy, xx


def roi_max_pool_plain(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
                       spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """feat (B, H, W, C), rois (B, R, 4) image coords -> (B, R, P, P, C):
    each bin's window reduced with max, empty bins 0."""
    b, _, _, c = feat.shape
    r = rois.shape[1]
    out = feat.new_empty((b * r, out_size, out_size, c))
    for idx, ph, pw, vals, ok, _, _ in _bin_windows(feat, rois, out_size, spatial_scale):
        out[idx, ph, pw] = torch.where(~ok.any(dim=1)[..., None], 0.0, vals.amax(dim=1))
    return out.reshape(b, r, out_size, out_size, c)


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
    r = rois.shape[1]
    dflat = torch.zeros((b * h * w, c), dtype=torch.float32, device=feat.device)
    gflat = g.reshape(b * r, out_size, out_size, c)
    big = h * w + 1
    for idx, ph, pw, vals, ok, yy, xx in _bin_windows(feat, rois, out_size, spatial_scale):
        vals = vals.float()
        hit = ok[..., None] & (vals == vals.amax(dim=1, keepdim=True))
        key = (xx * h + yy)[..., None].long()                 # column-major
        kmin = torch.where(hit, key, big).amin(dim=1)         # (n, C)
        nonempty = kmin < big
        cell = (idx // r * (h * w))[:, None] + (kmin % h) * w + kmin // h
        contrib = torch.where(nonempty, gflat[idx, ph, pw].float(), 0.0)
        dflat.scatter_add_(0, torch.where(nonempty, cell, 0), contrib)
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
    """Kernel K2: :func:`roi_max_pool_plain` on the card, one block per
    (image, RoI)."""
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
    profiling.count("launch.roi_pool")
    return out


_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p]
# shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
# shared memory a K4 block keeps for a chunk of RoIs: their bins' row and
# column ranges (csrc/roi_pool_bwd.cu kChunkBytes)
_CHUNK_BYTES = 8192


class BwdPlan(NamedTuple):
    """K4's tiling of a map: the variant, the channels (cc) and rows
    (band_rows) of a block, and its dynamic shared memory in bytes."""

    large: bool      # the large-map variant: feat walked from global memory
    cc: int
    band_rows: int
    smem: int


# the large-map variant's limits: 16-bit cell coordinates, int cell indices
LARGE_MAX_SIDE = 65535
LARGE_MAX_CELLS = 2**31 - 1


@lru_cache(maxsize=None)
def _bwd_plan(h: int, w: int, itemsize: int) -> BwdPlan:
    """K4's tiling of an h x w map whose elements take ``itemsize`` bytes.

    Shared-slice variant, for maps of at most 255 cells a side: a block
    holds its slice of cc channels of the whole map in feat's dtype (rounded
    up to 128 bytes), a float32 slab of band_rows x w x cc, and _CHUNK_BYTES
    for a chunk of RoIs, at most SMEM_LIMIT in all; cc is 16, 8 or 4, a
    multiple of the 16-byte vector (16 // itemsize channels).  Otherwise,
    or where no such plan fits, the large-map variant: the slab and the
    chunk only, cc of 16, 8 or 4 (a multiple of the vector) where one row of
    slab fits, else 2 or 1.  In each, the fewest bands of equal height win,
    then the widest cc.  Every map of at most LARGE_MAX_SIDE rows, 56064
    columns and LARGE_MAX_CELLS cells has a plan; any other raises."""
    vec = 16 // itemsize
    best = None
    for cc in (16, 8, 4):
        if cc % vec or h > 255 or w > 255:
            continue
        tile = -(-h * w * cc * itemsize // 128) * 128
        rows = (SMEM_LIMIT - _CHUNK_BYTES - tile) // (w * cc * 4)
        if rows >= 1 and (best is None or -(-h // rows) < best[1]):
            best = (cc, -(-h // rows), tile)
    if best is not None:
        cc, bands, tile = best
        rows = -(-h // bands)
        return BwdPlan(False, cc, rows, tile + rows * w * cc * 4 + _CHUNK_BYTES)
    if max(h, w) <= LARGE_MAX_SIDE and h * w <= LARGE_MAX_CELLS:
        for widths in ([cc for cc in (16, 8, 4) if cc % vec == 0], [2, 1]):
            for cc in widths:
                rows = (SMEM_LIMIT - _CHUNK_BYTES) // (w * cc * 4)
                if rows >= 1 and (best is None or -(-h // rows) < best[1]):
                    best = (cc, -(-h // rows))
            if best is not None:
                cc, bands = best
                rows = -(-h // bands)
                return BwdPlan(True, cc, rows, rows * w * cc * 4 + _CHUNK_BYTES)
    raise ValueError(f"no K4 plan for a {h} x {w} map of {itemsize}-byte elements")


def roi_pool_backward_cuda(feat: torch.Tensor, rois: torch.Tensor, g: torch.Tensor,
                           out_size: int = 7, spatial_scale: float = 1.0 / 16.0
                           ) -> torch.Tensor:
    """Kernel K4: :func:`roi_pool_backward_plain` on the card.  One launch
    writes every element of dfeat, allocated here in feat's dtype, from
    float32 sums kept in shared memory (tiling and variant from
    :func:`_bwd_plan`)."""
    _check_inputs("roi_pool_backward_cuda", feat, rois)
    b, h, w, c = feat.shape
    r = rois.shape[1]
    if (g.dtype != feat.dtype or g.device != feat.device or not g.is_contiguous()
            or tuple(g.shape) != (b, r, out_size, out_size, c)):
        raise ValueError(f"g must be a contiguous {feat.dtype} {(b, r, out_size, out_size, c)} "
                         f"tensor on {feat.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    dfeat = torch.empty_like(feat)
    if dfeat.numel() == 0:
        return dfeat
    plan = _bwd_plan(h, w, feat.element_size())
    name = "roi_pool_bwd_large" if plan.large else "roi_pool_bwd"
    fn = _build.function("roi_pool_bwd", f"trcnn_{name}", _BWD_ARGTYPES)
    err = fn(_build.ptr(feat), _build.ptr(rois), _build.ptr(g), b, r, h, w, c, out_size,
             spatial_scale, _DTYPE_CODE[feat.dtype], plan.cc, plan.band_rows, plan.smem,
             _build.ptr(dfeat), _build.stream_of(feat.device))
    _build.check(err, f"trcnn_{name}")
    profiling.count("launch." + name)
    return dfeat


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
