"""Host image preprocessing: the port's copy of
``trcnn/data/preprocess.py:26-100`` (numpy only).

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

from typing import Optional, Tuple

import numpy as np

from trcnn_torch.config import ImageConfig


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
