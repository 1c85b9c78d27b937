"""Greedy NMS over padded box sets, batched over images (port of
``trcnn/ops/nms.py`` under ``jax.vmap``).

``nms_padded`` has the contract of the JAX function: optional score sort
(stable, ties to the lower index), suppression by the division-free
``IoU > t`` predicate, optional same-group-only suppression, and compaction
of the first ``max_out`` survivors into indices plus a validity mask
(padding slots hold index 0).

The suppression itself runs in :func:`greedy_keep`: on a CUDA tensor it
launches kernel K1 (``csrc/nms.cu``), on a CPU tensor it runs
:func:`greedy_keep_plain`, the plain PyTorch version the kernel is held
against.  After ``nms_padded``'s score sort the valid entries of each
image are a prefix, so the suppression sees only the batch's longest valid
prefix (:func:`valid_prefix`): the COCO epilogue's 80 x 1000 (class, RoI)
pairs per image would otherwise give K1 an 800 MB mask per image.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from trcnn_torch import _build
from trcnn_torch.ops.boxes import box_overlap_gt
from trcnn_torch.utils import profiling

_NEG_INF = float("-inf")
_BLOCK = 64            # boxes per suppression-mask word (csrc/nms.cu)
_ROW_CHUNK = 1024      # rows of the pairwise predicate built at a time
# the reduce pass keeps one bit per box in shared memory, up to the 227 KB a
# block may have (the launcher lifts the 48 KB default)
_MAX_SMEM = 227 * 1024 - 2 * 1024


def _greedy_keep_one(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                     max_out: int, groups: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = boxes.shape[0]
    dev = boxes.device
    over = torch.empty((n, n), dtype=torch.bool, device=dev)
    for r0 in range(0, n, _ROW_CHUNK):
        over[r0:r0 + _ROW_CHUNK] = box_overlap_gt(boxes[r0:r0 + _ROW_CHUNK],
                                                  boxes, iou_thresh)
    over = torch.triu(over, diagonal=1)
    if groups is not None:
        over &= groups[:, None] == groups[None, :]
    keep = valid.clone()
    while True:
        new = valid & ~(over & keep[:, None]).any(dim=0)
        if torch.equal(new, keep):
            break
        keep = new
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    sel = torch.sort(torch.where(keep, pos, n)).values[:max_out]
    if sel.shape[0] < max_out:
        sel = torch.cat([sel, sel.new_full((max_out - sel.shape[0],), n)])
    keep_valid = sel < n
    return torch.where(keep_valid, sel, 0).to(torch.int32), keep_valid


def greedy_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                      max_out: int, groups: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over boxes already in score order, per image.

    boxes (B, N, 4) or (N, 4); valid and groups (B, N) or (N,).  For each
    image keep[c] = valid[c] & !any_{r<c}(keep[r] & IoU(r, c) > t), solved by
    Jacobi iteration from keep = valid: the recurrence is triangular, so its
    fixpoint is unique and equal to the sequential greedy result.

    Returns (keep_pos (B, max_out) int32 positions of the first max_out
    survivors, 0 in padding slots; keep_valid (B, max_out) bool), without
    the batch axis for an (N, 4) input.
    """
    if boxes.dim() == 2:
        return _greedy_keep_one(boxes, valid, iou_thresh, max_out, groups)
    outs = [_greedy_keep_one(boxes[i], valid[i], iou_thresh, max_out,
                             None if groups is None else groups[i])
            for i in range(boxes.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


_NMS_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def greedy_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                     max_out: int, groups: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1: :func:`greedy_keep_plain` on the card, one launch for the
    whole batch."""
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"greedy_keep_cuda needs CUDA tensors, got {dev}")
    if boxes.dim() == 2:
        keep_pos, keep_valid = greedy_keep_cuda(
            boxes[None], valid[None], iou_thresh, max_out,
            None if groups is None else groups[None])
        return keep_pos[0], keep_valid[0]
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[2] != 4 \
            or not boxes.is_contiguous():
        raise ValueError(f"boxes must be contiguous float32 (B, N, 4), got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    if valid.dtype != torch.bool or valid.shape != (b, n) or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool (B, N) tensor")
    if groups is not None and (groups.dtype != torch.int32 or groups.shape != (b, n)
                               or not groups.is_contiguous()):
        raise ValueError("groups must be a contiguous int32 (B, N) tensor")
    for t in (valid, groups):
        if t is not None and t.device != dev:
            raise ValueError("all NMS inputs must be on one device")
    if max_out < 1:
        raise ValueError("max_out must be positive")
    col_blocks = -(-n // _BLOCK)
    if col_blocks * 8 > _MAX_SMEM:
        raise ValueError(f"{n} boxes exceed the reduce pass's shared memory")
    if b > 65535:
        raise ValueError(f"a batch of {b} exceeds the mask pass's grid")
    mask = torch.empty((b, n, col_blocks), dtype=torch.int64, device=dev)
    keep_pos = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    num_kept = torch.empty(b, dtype=torch.int32, device=dev)
    fn = _build.function("nms", "trcnn_nms", _NMS_ARGTYPES)
    err = fn(_build.ptr(boxes),
             _build.ptr(groups) if groups is not None else None,
             _build.ptr(valid), b, n, iou_thresh, max_out, _build.ptr(mask),
             _build.ptr(keep_pos), _build.ptr(num_kept), _build.stream_of(dev))
    _build.check(err, "trcnn_nms")
    profiling.count("launch.nms")
    keep_valid = torch.arange(max_out, device=dev) < num_kept[:, None]
    return keep_pos, keep_valid


def greedy_keep(boxes, valid, iou_thresh, max_out, groups=None):
    """Dispatch: kernel K1 for CUDA tensors, the plain version for CPU."""
    if boxes.device.type == "cuda":
        return greedy_keep_cuda(boxes, valid, iou_thresh, max_out, groups)
    if boxes.device.type == "cpu":
        return greedy_keep_plain(boxes, valid, iou_thresh, max_out, groups)
    raise ValueError(f"no NMS for device {boxes.device}")


def valid_prefix(svalid: torch.Tensor) -> int:
    """The suppression's width for score-sorted validity flags (B, N), whose
    valid entries are each row's prefix: the longest row's valid count,
    rounded up to K1's 64-box mask words, at least one word and at most N.
    An invalid entry is never kept and never suppresses, so the entries
    past it cannot change the result.  On the card this is one
    device-to-host read (the site ``nms.valid_prefix``)."""
    n = svalid.shape[-1]
    longest = profiling.host_read(lambda: int(svalid.sum(-1).max()),
                                  "nms.valid_prefix") if svalid.numel() else 0
    return min(n, max(_BLOCK, -(-longest // _BLOCK) * _BLOCK))


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_thresh: float, max_out: int, presorted: bool = False,
               groups: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over padded sets, per image: (B, N, 4) boxes, (B, N)
    scores and valid, or one image without the batch axis.

    ``presorted``: the caller guarantees score order already (e.g. straight
    out of ``masked_topk_payload``), so the sort is skipped.  ``groups``:
    optional (B, N) int32 ids; only same-group pairs suppress.  After the
    sort only the batch's longest valid prefix is suppressed
    (:func:`valid_prefix`); presorted input is taken whole, with no read
    back to the host.

    Returns (keep_idx (B, max_out) int32 indices into each image's inputs,
    score ordered, 0 in padding slots; keep_valid (B, max_out) bool).
    """
    if boxes.dim() == 2:
        keep_idx, keep_valid = nms_padded(
            boxes[None], scores[None], valid[None], iou_thresh, max_out, presorted,
            None if groups is None else groups[None])
        return keep_idx[0], keep_valid[0]
    boxes = boxes.float()
    if groups is not None:
        groups = groups.to(torch.int32)
    if presorted:
        order = None
        sboxes, svalid = boxes.contiguous(), valid.contiguous()
        sgroups = groups.contiguous() if groups is not None else None
    else:
        masked = torch.where(valid, scores.float(), _NEG_INF)
        neg, order = torch.sort(-masked, dim=-1, stable=True)
        svalid = -neg > _NEG_INF
        n = valid_prefix(svalid)
        order, svalid = order[:, :n], svalid[:, :n].contiguous()
        sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        sgroups = torch.gather(groups, 1, order) if groups is not None else None
    keep_pos, keep_valid = greedy_keep(sboxes, svalid, iou_thresh, max_out,
                                       sgroups)
    keep_idx = keep_pos if order is None else torch.gather(order, 1, keep_pos.long())
    keep_idx = torch.where(keep_valid, keep_idx, 0).to(torch.int32)
    return keep_idx, keep_valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                iou_thresh: float, max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_padded`` over one leading batch axis (``trcnn/ops/nms.py:231``,
    a ``jax.vmap`` there): boxes (B, N, 4), scores and valid (B, N); one K1
    launch for the batch.  Returns (keep_idx, keep_valid), each (B, max_out)."""
    if boxes.dim() != 3:
        raise ValueError(f"batched_nms takes (B, N, 4) boxes, got {tuple(boxes.shape)}")
    return nms_padded(boxes, scores, valid, iou_thresh, max_out)


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   iou_thresh: float, score_thresh: float, max_per_class: int,
                   max_total: int, class_offset: int = 1):
    """Test-time per-class NMS + merge (``trcnn/ops/nms.py:249``), per image.

    Args: boxes (B, R, C, 4) class-specific or (B, R, 4) shared; scores
    (B, R, C) with background at column 0; valid (B, R); or one image
    without the batch axis.  Returns (det_boxes (B, D, 4), det_scores
    (B, D), det_classes (B, D) int32, det_valid (B, D)), D = max_total,
    score-sorted.

    With ``max_per_class >= max_total`` (the VOC and COCO test configs)
    per-class NMS + merge is exactly one grouped greedy NMS over the
    flattened (class, roi) set.  Otherwise each (image, class) row is its
    own NMS down to ``max_per_class``, then the survivors of an image are
    merged by a stable sort on score (``lax.top_k``'s order).  Either way
    one K1 launch serves the batch: the grouped set's batch axis is B, the
    per-class rows' is B * (C - class_offset).
    """
    if scores.dim() == 2:
        out = multiclass_nms(boxes[None], scores[None], valid[None], iou_thresh,
                             score_thresh, max_per_class, max_total, class_offset)
        return tuple(t[0] for t in out)
    b, r, c = scores.shape
    fg = c - class_offset
    if boxes.dim() == 3:
        boxes = boxes[:, :, None, :].expand(b, r, c, 4)
    cls_boxes = boxes[:, :, class_offset:, :].transpose(1, 2)    # (B, FG, R, 4)
    cls_scores = scores[:, :, class_offset:].transpose(1, 2)     # (B, FG, R)
    cls_valid = valid[:, None, :] & (cls_scores > score_thresh)
    if max_per_class < max_total:
        return _per_class_nms(cls_boxes, cls_scores, cls_valid, iou_thresh, max_per_class,
                              max_total, class_offset)
    flat_boxes = cls_boxes.reshape(b, fg * r, 4)
    flat_scores = cls_scores.reshape(b, fg * r)
    flat_valid = cls_valid.reshape(b, fg * r)
    flat_groups = torch.arange(fg, dtype=torch.int32,
                               device=scores.device).repeat_interleave(r).expand(b, -1)
    keep_idx, keep_valid = nms_padded(flat_boxes, flat_scores, flat_valid,
                                      iou_thresh, max_total, groups=flat_groups)
    k = keep_idx.long()
    det_scores = torch.where(keep_valid, torch.gather(flat_scores, 1, k), 0.0)
    det_boxes = torch.where(keep_valid[..., None],
                            torch.gather(flat_boxes, 1, k[..., None].expand(-1, -1, 4)), 0.0)
    det_classes = torch.where(keep_valid, keep_idx // r + class_offset, 0)
    return det_boxes, det_scores, det_classes.to(torch.int32), keep_valid


def _per_class_nms(cls_boxes, cls_scores, cls_valid, iou_thresh, max_per_class, max_total,
                   class_offset):
    """``multiclass_nms``'s general path (``trcnn/ops/nms.py:327-349``) on
    (B, FG, R, ...) class-major inputs: NMS per (image, class) row to
    ``max_per_class``, then each image's FG x max_per_class survivors merged
    into the ``max_total`` best, ties to the lower (class, slot) index."""
    b, fg, r = cls_scores.shape
    if fg * max_per_class < max_total:
        raise ValueError(f"{fg} classes x {max_per_class} per class cannot fill {max_total}")
    keep_idx, keep_valid = nms_padded(cls_boxes.reshape(b * fg, r, 4),
                                      cls_scores.reshape(b * fg, r),
                                      cls_valid.reshape(b * fg, r), iou_thresh, max_per_class)
    k = keep_idx.long().reshape(b, fg, max_per_class)
    g_boxes = torch.gather(cls_boxes, 2, k[..., None].expand(-1, -1, -1, 4))
    g_scores = torch.where(keep_valid.reshape(b, fg, max_per_class),
                           torch.gather(cls_scores.float(), 2, k), _NEG_INF)
    flat_scores = g_scores.reshape(b, fg * max_per_class)
    neg, top = torch.sort(-flat_scores, dim=-1, stable=True)
    top, top_scores = top[:, :max_total], -neg[:, :max_total]
    det_valid = top_scores > _NEG_INF
    det_boxes = torch.gather(g_boxes.reshape(b, fg * max_per_class, 4), 1,
                             top[..., None].expand(-1, -1, 4))
    det_classes = torch.where(det_valid, top // max_per_class + class_offset, 0)
    return (torch.where(det_valid[..., None], det_boxes, 0.0),
            torch.where(det_valid, top_scores, 0.0), det_classes.to(torch.int32), det_valid)
