"""Box transforms, clipping and the IoU predicate (port of
``trcnn/ops/boxes.py``).

Every function keeps the "+1" pixel convention (width = x2 - x1 + 1) and
broadcasts over leading batch dimensions; boxes are (..., 4) float tensors
in (x1, y1, x2, y2).  Each operation is a separate PyTorch op, so no
multiply-add is contracted and the float32 rounding follows the JAX code
step for step.
"""

from __future__ import annotations

import math

import torch

# Clamp on (dw, dh) before exp() in decode (trcnn/ops/boxes.py:23).
DELTA_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w * h


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor,
                       delta_clip: float | None = DELTA_CLIP) -> torch.Tensor:
    """Decode regression deltas on top of boxes.  ``deltas`` may carry 4*K
    channels (class-specific regression); boxes broadcast over the K groups."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx, dy, dw, dh = d.unbind(-1)
    if delta_clip is not None:
        dw = torch.clamp(dw, max=delta_clip)
        dh = torch.clamp(dh, max=delta_clip)
    w, h, cx, cy = (x[..., None] for x in (w, h, cx, cy))
    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    out = torch.stack([pred_cx - 0.5 * (pred_w - 1.0),
                       pred_cy - 0.5 * (pred_h - 1.0),
                       pred_cx + 0.5 * (pred_w - 1.0),
                       pred_cy + 0.5 * (pred_h - 1.0)], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, im_h, im_w) -> torch.Tensor:
    """Clip to [0, W-1] x [0, H-1]; ``im_h``/``im_w`` are numbers or 0-d
    tensors on the boxes' device (per-image extents inside a padded batch).
    Supports 4*K channel groups."""
    im_h = torch.as_tensor(im_h, dtype=boxes.dtype, device=boxes.device)
    im_w = torch.as_tensor(im_w, dtype=boxes.dtype, device=boxes.device)
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    x1 = torch.minimum(b[..., 0].clamp(min=0.0), im_w - 1.0)
    y1 = torch.minimum(b[..., 1].clamp(min=0.0), im_h - 1.0)
    x2 = torch.minimum(b[..., 2].clamp(min=0.0), im_w - 1.0)
    y2 = torch.minimum(b[..., 3].clamp(min=0.0), im_h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def box_overlap_gt(boxes: torch.Tensor, query: torch.Tensor,
                   thresh: float) -> torch.Tensor:
    """Pairwise ``IoU > thresh`` (..., N, K), division-free:
    ``inter * (1 + t) > t*a + t*b``, evaluated in exactly that order."""
    # a 0-d CPU tensor acts as a float32 scalar on any device, with no copy
    t = torch.tensor(thresh, dtype=torch.float32)
    ta_n = t * box_area(boxes)[..., :, None]
    ta_k = t * box_area(query)[..., None, :]
    lt = torch.maximum(boxes[..., :, None, :2], query[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], query[..., None, :, 2:])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter * (1.0 + t) > ta_n + ta_k
