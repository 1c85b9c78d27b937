"""The discrete layers of Faster R-CNN, re-derived: anchors, box decoding
and clipping, the proposal layer and the test-time epilogue, with the
greedy NMS as a host loop.

A translation of ``tests/cross_impl_reference.py``'s proposal and
epilogue stages (and of the NMS oracle it takes from the JAX package) that
imports neither the JAX package nor the port.  The arithmetic that feeds a
discrete decision keeps the published float32 order, one operation at a
time: the "+1" box convention, the decode's clip of dw and dh at
log(1000 / 16), and the IoU predicate in its division-free form
``inter * (1 + t) > t * area_i + t * area_j``, so that the decisions are
the contract's and not a rounding's.  Boxes are decoded on the tensors'
device; sorting and suppression run in numpy on the host.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

F32 = np.float32
DELTA_CLIP = math.log(1000.0 / 16.0)


def base_anchors(base_size: int = 16, ratios=(0.5, 1.0, 2.0), scales=(8.0, 16.0, 32.0)
                 ) -> np.ndarray:
    """The A base anchors: each ratio keeps the rounded area of the
    base_size cell, then each scale multiplies its sides (ratio major)."""
    out = []
    ctr = (base_size - 1) / 2.0
    for r in ratios:
        ws = round(math.sqrt(base_size * base_size / r))
        hs = round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            out.append([ctr - 0.5 * (w - 1), ctr - 0.5 * (h - 1),
                        ctr + 0.5 * (w - 1), ctr + 0.5 * (h - 1)])
    return np.asarray(out, F32)


def all_anchors(fh: int, fw: int, stride: int, base: np.ndarray, device) -> torch.Tensor:
    """(fh * fw * A, 4): grid position major (y outer, x inner), anchor minor."""
    ys, xs = np.meshgrid(np.arange(fh, dtype=F32) * stride, np.arange(fw, dtype=F32) * stride,
                         indexing="ij")
    shifts = np.stack([xs.ravel(), ys.ravel(), xs.ravel(), ys.ravel()], 1)
    return torch.from_numpy((shifts[:, None, :] + base[None]).reshape(-1, 4)).to(device)


def decode(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """bbox_transform_inv: boxes (..., 4) broadcast over the 4K channels of
    deltas (..., 4K)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    w, h, cx, cy = (t[..., None] for t in (w, h, cx, cy))
    pcx = d[..., 0] * w + cx
    pcy = d[..., 1] * h + cy
    pw = torch.exp(torch.clamp(d[..., 2], max=DELTA_CLIP)) * w
    ph = torch.exp(torch.clamp(d[..., 3], max=DELTA_CLIP)) * h
    out = torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                       pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)], -1)
    return out.reshape(deltas.shape)


def clip(boxes: torch.Tensor, im_h: torch.Tensor, im_w: torch.Tensor) -> torch.Tensor:
    """Clip to [0, W - 1] x [0, H - 1]; boxes (..., 4K) are viewed as
    (..., K, 4), and im_h, im_w broadcast against that view's (..., K)."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    hi_x, hi_y = im_w - 1.0, im_h - 1.0
    out = torch.stack([torch.minimum(b[..., 0].clamp(min=0.0), hi_x),
                       torch.minimum(b[..., 1].clamp(min=0.0), hi_y),
                       torch.minimum(b[..., 2].clamp(min=0.0), hi_x),
                       torch.minimum(b[..., 3].clamp(min=0.0), hi_y)], -1)
    return out.reshape(boxes.shape)


def greedy_nms(boxes: np.ndarray, thresh: float, max_out: int) -> List[int]:
    """Greedy NMS over float32 boxes already in score order: the positions
    of the first ``max_out`` survivors.  A box is suppressed by an earlier
    survivor when inter * (1 + t) > t * a_i + t * a_j in float32."""
    t = F32(thresh)
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    ta = t * ((x2 - x1 + F32(1.0)) * (y2 - y1 + F32(1.0)))
    alive = np.arange(boxes.shape[0])
    keep: List[int] = []
    while alive.size and len(keep) < max_out:
        i = alive[0]
        keep.append(int(i))
        rest = alive[1:]
        iw = np.maximum(np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + F32(1.0),
                        F32(0.0))
        ih = np.maximum(np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]) + F32(1.0),
                        F32(0.0))
        alive = rest[~(iw * ih * (F32(1.0) + t) > ta[i] + ta[rest])]
    return keep


def stable_desc(scores: np.ndarray) -> np.ndarray:
    """Order by descending score, ties to the lower index."""
    return np.argsort(-scores, kind="stable")


def proposals(fg_probs: torch.Tensor, deltas: torch.Tensor, im_info: torch.Tensor, cfg,
              train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The proposal layer for a batch: fg_probs (B, fH, fW, A), deltas
    (B, fH, fW, A, 4), im_info (B, 3) -> (rois (B, post, 4), valid (B, post))
    as numpy.  Decode on the anchors, clip to the image, drop boxes under
    min_size * im_scale and grid cells past the image's feature extent, keep
    the top pre_nms by a stable sort, NMS down to post_nms."""
    b, fh, fw, a = fg_probs.shape
    ac, pc = cfg.anchors, cfg.proposals
    anchors = all_anchors(fh, fw, ac.feat_stride, base_anchors(ac.base_size, ac.ratios,
                                                                ac.scales), fg_probs.device)
    im_h, im_w = im_info[:, 0:1].float(), im_info[:, 1:2].float()
    boxes = clip(decode(anchors, deltas.reshape(b, -1, 4).float()), im_h[..., None],
                 im_w[..., None])
    min_size = pc.min_size * im_info[:, 2:3].float()
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    ok = (ws >= min_size) & (hs >= min_size)
    gy = torch.arange(fh, device=boxes.device)[None, :, None]
    gx = torch.arange(fw, device=boxes.device)[None, None, :]
    grid = (gy < torch.ceil(im_h / ac.feat_stride)[..., None]) \
        & (gx < torch.ceil(im_w / ac.feat_stride)[..., None])
    ok &= grid.reshape(b, -1).repeat_interleave(a, 1)
    scores = torch.where(ok, fg_probs.reshape(b, -1).float(), float("-inf"))
    scores, boxes = scores.cpu().numpy(), boxes.cpu().numpy()
    pre = pc.pre_nms_topk_train if train else pc.pre_nms_topk_test
    post = pc.post_nms_topk_train if train else pc.post_nms_topk_test
    rois = np.zeros((b, post, 4), F32)
    valid = np.zeros((b, post), bool)
    for i in range(b):
        order = stable_desc(scores[i])[:pre]
        order = order[scores[i][order] > -np.inf]
        keep = greedy_nms(boxes[i][order], pc.nms_thresh, post)
        rois[i, :len(keep)] = boxes[i][order[keep]]
        valid[i, :len(keep)] = True
    return rois, valid


def postprocess(rois: torch.Tensor, roi_valid: torch.Tensor, cls_prob: torch.Tensor,
                bbox_pred: torch.Tensor, im_info: torch.Tensor, cfg
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The test-time epilogue for a batch: de-normalise the class-specific
    deltas, decode, clip, per-class greedy NMS of the boxes scoring over
    the threshold, merge by a stable sort on score (ties class-major, then
    RoI order), keep max_total and divide by im_scale.  Returns numpy
    (boxes (B, D, 4), scores (B, D), classes (B, D), valid (B, D))."""
    b, r, k = cls_prob.shape
    t, pt = cfg.test, cfg.proposal_targets
    dev = rois.device
    stds = torch.tensor(tuple(pt.bbox_normalize_stds) * k, dtype=torch.float32, device=dev)
    means = torch.tensor(tuple(pt.bbox_normalize_means) * k, dtype=torch.float32, device=dev)
    deltas = bbox_pred.float() * stds + means
    info = im_info[:, None, None, :].float()
    boxes = clip(decode(rois.float(), deltas), info[..., 0], info[..., 1])
    boxes = boxes.reshape(b, r, k, 4).cpu().numpy()
    probs = cls_prob.float().cpu().numpy()
    valid_np = roi_valid.cpu().numpy()
    scale = im_info[:, 2].float().cpu().numpy()
    d = t.max_dets_per_image
    out = (np.zeros((b, d, 4), F32), np.zeros((b, d), F32), np.zeros((b, d), np.int32),
           np.zeros((b, d), bool))
    for i in range(b):
        found = []                           # (score, class-major flat index, class, box)
        for c in range(1, k):
            sc = probs[i, :, c]
            idx = np.flatnonzero(valid_np[i] & (sc > F32(t.score_thresh_eval)))
            if not idx.size:
                continue
            idx = idx[stable_desc(sc[idx])]
            for j in greedy_nms(boxes[i, idx, c], t.nms_thresh, d):
                found.append((sc[idx[j]], (c - 1) * r + idx[j], c, boxes[i, idx[j], c]))
        found.sort(key=lambda f: (-f[0], f[1]))
        for slot, (s, _, c, box) in enumerate(found[:d]):
            out[0][i, slot] = box / scale[i]
            out[1][i, slot], out[2][i, slot], out[3][i, slot] = s, c, True
    return out
