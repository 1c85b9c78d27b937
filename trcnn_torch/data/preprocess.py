"""Image preprocessing: the port's copy of ``trcnn/data/preprocess.py``,
the host path (numpy, lines 26-100) and :func:`preprocess_device` (torch,
on any device, lines 102-147).

BGR channel order, Caffe pixel means, the 600/1000 scale rule, and the
static padded canvas: every image lands in the top-left corner of a
(pad_h, pad_w) buffer for landscape images, (pad_w, pad_h) for portrait
ones, zeros elsewhere.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)`` on float32.
The port's resize is its own numpy bilinear, :func:`resize_bilinear`,
written to OpenCV's generic C++ path (``cv::resize``'s ``resizeGeneric``
with ``HResizeLinear`` / ``VResizeLinear``, the one ``cv2`` takes under
``cv2.setUseOptimized(False)``), and bit-equal to it:

- source coordinate of destination column dx: ``fx = float32((dx + 0.5) *
  scale - 0.5)`` with the scale ``1 / (dst / src)`` in float64; ``sx =
  floor(fx)``, ``fx -= sx`` in float32; weights ``1 - fx`` and ``fx``;
- columns: left of the image (sx < 0) the first column with weights (1, 0);
  from the column where sx + 1 reaches the last one, a copy of the last
  column; rows: both taps clipped into the image, weights unchanged;
- each pass is ``a * w0 + b * w1``, every product and the sum rounded to
  float32 (no fused multiply-add): columns first, then rows.

cv2's default dispatch (SIMD or IPP) rounds otherwise at some scales:
``tests/test_torch_data.py`` states by how much.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import numpy as np
import torch

from trcnn_torch.config import ImageConfig
from trcnn_torch.ops.boxes import device_constant


def compute_scale(h: int, w: int, cfg: ImageConfig = ImageConfig(),
                  min_size: Optional[int] = None) -> float:
    """The 600/1000 rule: the shorter side to ``target_min_size`` (or
    ``min_size``, which multi-scale training draws per image), capped so
    that the longer side stays within ``target_max_size``."""
    short, long = min(h, w), max(h, w)
    target = min_size if min_size is not None else cfg.target_min_size
    scale = target / float(short)
    if round(scale * long) > cfg.target_max_size:
        scale = cfg.target_max_size / float(long)
    return scale


def canvas_shape(h: int, w: int, cfg: ImageConfig = ImageConfig()) -> Tuple[int, int]:
    """The canvas bucket of an image: (pad_h, pad_w) for landscape, the
    transpose for portrait."""
    return (cfg.pad_h, cfg.pad_w) if w >= h else (cfg.pad_w, cfg.pad_h)


def _taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first tap, float32 fraction) of each destination index."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), f - s


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) float32 -> (height, width, C) float32, bit-equal to
    OpenCV's generic ``INTER_LINEAR`` (module docstring): two gathers and
    two weighted sums, no Python loop over pixels."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    one = np.float32(1.0)
    sx, fx = _taps(w, width)
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    last = sx >= w - 1
    fx[last] = 0.0
    sx[last] = w - 1
    sx1 = np.minimum(sx + 1, w - 1)
    cols = (img[:, sx] * (one - fx)[None, :, None]
            + img[:, sx1] * fx[None, :, None])          # (H, width, C)
    sy, fy = _taps(h, height)
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    return cols[r0] * (one - fy)[:, None, None] + cols[r1] * fy[:, None, None]


def preprocess_image(img_bgr: np.ndarray, cfg: ImageConfig = ImageConfig(), flip: bool = False,
                     min_size: Optional[int] = None, as_uint8: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """One BGR uint8 image -> (canvas, im_info).

    canvas: the orientation bucket of :func:`canvas_shape`, the scaled
    (and, with ``flip``, mirrored) image in its top-left corner, zeros
    elsewhere; float32 minus the pixel means (the default, the reference's
    preprocessing), or with ``as_uint8`` the rounded uint8 pixels without
    the means (the model subtracts them on the device: a quarter of the
    upload).  im_info: float32 (scaled_h, scaled_w, scale).
    """
    h, w = img_bgr.shape[:2]
    scale = compute_scale(h, w, cfg, min_size=min_size)
    sw, sh = int(round(w * scale)), int(round(h * scale))
    pad_h, pad_w = canvas_shape(h, w, cfg)
    if sh > pad_h or sw > pad_w:
        raise ValueError(f"scaled image {sh}x{sw} exceeds canvas {pad_h}x{pad_w}")
    img = img_bgr[:, ::-1] if flip else img_bgr
    resized = resize_bilinear(img.astype(np.float32), sw, sh)
    info = np.asarray([sh, sw, scale], dtype=np.float32)
    if as_uint8:
        canvas = np.zeros((pad_h, pad_w, 3), dtype=np.uint8)
        canvas[:sh, :sw] = np.clip(np.rint(resized), 0, 255).astype(np.uint8)
        return canvas, info
    resized -= np.asarray(cfg.pixel_means_bgr, dtype=np.float32)
    canvas = np.zeros((pad_h, pad_w, 3), dtype=np.float32)
    canvas[:sh, :sw] = resized
    return canvas, info


def scale_gt_boxes(boxes: np.ndarray, scale: float, orig_w: int, flip: bool = False) -> np.ndarray:
    """gt boxes to canvas coordinates: mirrored first with ``flip`` (the
    +1 convention, x' = W - 1 - x), then scaled."""
    boxes = np.asarray(boxes, dtype=np.float32).copy()
    if flip and boxes.size:
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = orig_w - 1.0 - boxes[:, 2]
        boxes[:, 2] = orig_w - 1.0 - x1
    return boxes * scale


def _weight_mat(n_in: int, n_out: int, scale: torch.Tensor) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.scale_and_translate``'s
    linear (triangle) kernel without antialiasing and with no translation,
    as ``jax/_src/image/scale.py::compute_weight_mat`` makes them: sample
    positions ``(j + 0.5) / scale - 0.5``, weights ``max(0, 1 - |sample -
    i|)``, each column divided by its sum (0 where the sum is at most 1000
    float32 eps), and 0 for samples outside ``[-0.5, n_in - 0.5]``."""
    dev = scale.device
    inv = 1.0 / scale
    sample = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=dev)[:, None]).abs()
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls in float32 on the card (TF32 would round the
    inputs to 10 mantissa bits)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def preprocess_device(raw_u8: torch.Tensor, raw_h: Union[int, torch.Tensor],
                      raw_w: Union[int, torch.Tensor], scale: Union[float, torch.Tensor],
                      cfg: ImageConfig = ImageConfig()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preprocessing on the raw buffer's device: raw uint8 buffer ->
    mean-subtracted canvas, the counterpart of the JAX package's jittable
    ``preprocess_device``.

    raw_u8: (RAW_H, RAW_W, 3) uint8 BGR, the image in the top-left corner
    (contents beyond ``raw_h`` x ``raw_w`` are ignored); ``scale``: the
    resize factor (:func:`compute_scale`).  Returns (canvas (cfg.pad_h,
    cfg.pad_w, 3) float32, im_info (3,) float32 = (sh, sw, scale)) on that
    device; the canvas goes straight into ``FasterRCNN.detect`` (float
    input skips its uint8 preparation).  A portrait image takes the
    portrait bucket's config (pad_h and pad_w swapped, :func:`canvas_shape`).

    The resize is JAX's ``scale_and_translate(method="linear",
    antialias=False)``, not cv2's: half-pixel sample positions, zeros
    outside the image, so the masked raw buffer's zeros bleed into the
    scaled image's last row and column (cv2 clamps there).  The target
    size is ``round(raw * scale)`` in float32, half to even as
    ``jnp.round``, and each axis's scale is that size over the raw one.
    The two contractions run in float32 (TF32 off for them on the card).
    """
    dev = raw_u8.device
    x = raw_u8.to(torch.float32)
    if any(torch.is_tensor(v) for v in (raw_h, raw_w, scale)):
        extent = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                              for v in (raw_h, raw_w, scale)])
    else:                   # one upload from pinned memory: the stream does not wait
        extent = torch.tensor([raw_h, raw_w, scale], dtype=torch.float32)
        if dev.type == "cuda":
            extent = extent.pin_memory()
        extent = extent.to(dev, non_blocking=True)
    raw_h, raw_w, s = extent.unbind()
    yy = torch.arange(x.shape[0], device=dev)[:, None, None]
    xx = torch.arange(x.shape[1], device=dev)[None, :, None]
    x = torch.where((yy < raw_h) & (xx < raw_w), x, 0.0)

    sh = torch.round(raw_h * s)
    sw = torch.round(raw_w * s)
    wh = _weight_mat(x.shape[0], cfg.pad_h, sh / raw_h)
    ww = _weight_mat(x.shape[1], cfg.pad_w, sw / raw_w)
    with _no_tf32():
        rows = torch.tensordot(wh, x, dims=([0], [0]))                     # (pad_h, RAW_W, 3)
        canvas = torch.tensordot(ww, rows, dims=([0], [1])).transpose(0, 1)  # (pad_h, pad_w, 3)
    yy2 = torch.arange(cfg.pad_h, device=dev)[:, None, None]
    xx2 = torch.arange(cfg.pad_w, device=dev)[None, :, None]
    inside = (yy2 < sh) & (xx2 < sw)
    canvas = torch.where(inside, canvas - device_constant(cfg.pixel_means_bgr, dev), 0.0)
    return canvas.contiguous(), torch.stack([sh, sw, s])
