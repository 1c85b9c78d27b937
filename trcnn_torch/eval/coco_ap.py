"""COCO-style detection AP, AP@[.5:.95] with 101-point interpolation: the
port's copy of ``trcnn/eval/coco_ap.py`` (numpy only, no pycocotools).

The COCOeval bbox protocol: per class and IoU threshold, detections in
score order each match the best remaining ground truth with IoU >= t;
crowd regions absorb any number of detections without penalty; AP is the
mean over the ten thresholds .50:.05:.95 of the 101-point interpolated
precision.  Area ranges (small, medium, large) follow COCO's definitions.

Boxes are in the pipeline's inclusive convention (``COCODetection`` makes
x2 = x + w - 1, and the detector predicts the same), so widths here are
x2 - x1 + 1: exactly COCOeval's x2 - x1 on the json's x2 = x + w.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}


def _iou_xyxy(det: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU on discrete-convention boxes (w = x2−x1+1 ≡ COCOeval's
    continuous w on the original boxes); for crowd gt the denominator is
    the detection area (COCO 'iscrowd' semantics)."""
    d = det[:, None, :]
    g = gt[None, :, :]
    iw = np.maximum(0.0, np.minimum(d[..., 2], g[..., 2]) -
                    np.maximum(d[..., 0], g[..., 0]) + 1.0)
    ih = np.maximum(0.0, np.minimum(d[..., 3], g[..., 3]) -
                    np.maximum(d[..., 1], g[..., 1]) + 1.0)
    inter = iw * ih
    area_d = _area(det)
    area_g = _area(gt)
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(crowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / union, 0.0)


def _area(boxes: np.ndarray) -> np.ndarray:
    """Discrete-convention box area ≡ original continuous w·h."""
    if len(boxes) == 0:
        return np.zeros((0,))
    return ((boxes[:, 2] - boxes[:, 0] + 1.0) *
            (boxes[:, 3] - boxes[:, 1] + 1.0))


def _eval_image(dets: np.ndarray, det_scores: np.ndarray, gts: np.ndarray,
                crowd: np.ndarray, gt_ignore: np.ndarray,
                thresholds: np.ndarray):
    """Greedy matching for one image+class → (matched (T, D) bool,
    det_ignore (T, D) bool)."""
    order = np.argsort(-det_scores, kind="stable")
    dets = dets[order]
    nd, ng = len(dets), len(gts)
    nt = len(thresholds)
    tp = np.zeros((nt, nd), bool)
    ignore = np.zeros((nt, nd), bool)
    if ng:
        iou = _iou_xyxy(dets, gts, crowd)
        # sort gts: non-ignored first (COCOeval match order)
        gorder = np.argsort(gt_ignore, kind="stable")
        for ti, t in enumerate(thresholds):
            taken = np.zeros(ng, bool)
            for di in range(nd):
                best = -1
                best_iou = min(t, 1.0 - 1e-10)
                for gj in gorder:
                    if taken[gj] and not crowd[gj]:
                        continue
                    # once matched to a real gt, stop at the ignored block
                    if best >= 0 and not gt_ignore[best] and gt_ignore[gj]:
                        break
                    if iou[di, gj] < best_iou:
                        continue
                    best, best_iou = gj, iou[di, gj]
                if best >= 0:
                    if gt_ignore[best]:
                        ignore[ti, di] = True
                    else:
                        tp[ti, di] = True
                        taken[best] = True
    return tp, ignore, order


def coco_eval(
    detections: List[dict],
    annotations: Dict[str, dict],
    num_classes: int,
    area_range: str = "all",
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO bbox AP.

    Args:
      detections: per image {'id', 'boxes' xyxy, 'scores', 'classes'}.
      annotations: {'id': {'boxes' xyxy, 'labels', 'crowd' (G,) bool}}.
      num_classes: including background at 0.

    Returns {'AP': mAP@[.5:.95], 'AP50':…, 'AP75':…}.
    """
    lo, hi = AREA_RANGES[area_range]
    ap_per_class = []
    ap50_per_class = []
    ap75_per_class = []
    for ci in range(1, num_classes):
        scores_all, tp_all, ig_all = [], [], []
        npos = 0
        for det in detections:
            iid = det["id"]
            ann = annotations.get(iid, {"boxes": np.zeros((0, 4)),
                                        "labels": np.zeros((0,), int),
                                        "crowd": np.zeros((0,), bool)})
            m = np.asarray(det["classes"]) == ci
            dboxes = np.asarray(det["boxes"], np.float64)[m][:max_dets]
            dscores = np.asarray(det["scores"], np.float64)[m][:max_dets]
            gm = np.asarray(ann["labels"]) == ci
            gboxes = np.asarray(ann["boxes"], np.float64)[gm]
            crowd_full = np.asarray(
                ann.get("crowd", np.zeros(len(gm), bool)), bool)
            crowd = (crowd_full[gm] if len(crowd_full) == len(gm)
                     else np.zeros(len(gboxes), bool))
            areas_g = _area(gboxes)
            gt_ignore = crowd | (areas_g < lo) | (areas_g > hi)
            npos += int((~gt_ignore).sum())

            tp, ignore, order = _eval_image(
                dboxes, dscores, gboxes, crowd, gt_ignore, IOU_THRESHOLDS)
            # detection-side area filter: unmatched dets outside the range
            # are ignored, not penalized
            areas_d = _area(dboxes)[order] if len(dboxes) else np.zeros((0,))
            out_of_range = (areas_d < lo) | (areas_d > hi)
            ignore = ignore | (out_of_range[None, :] & ~tp)
            scores_all.append(dscores[order])
            tp_all.append(tp)
            ig_all.append(ignore)

        if npos == 0:
            continue
        scores = np.concatenate(scores_all) if scores_all else np.zeros((0,))
        tp = (np.concatenate(tp_all, axis=1) if tp_all
              else np.zeros((len(IOU_THRESHOLDS), 0), bool))
        ig = (np.concatenate(ig_all, axis=1) if ig_all
              else np.zeros((len(IOU_THRESHOLDS), 0), bool))
        order = np.argsort(-scores, kind="stable")
        tp = tp[:, order]
        ig = ig[:, order]

        aps = []
        for ti in range(len(IOU_THRESHOLDS)):
            keep = ~ig[ti]
            t = tp[ti][keep]
            ctp = np.cumsum(t)
            cfp = np.cumsum(~t)
            recall = ctp / npos
            precision = ctp / np.maximum(ctp + cfp, 1e-12)
            # monotone envelope + 101-point interpolation
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            p = np.where(idx < len(precision), precision[np.minimum(
                idx, max(len(precision) - 1, 0))], 0.0) \
                if len(precision) else np.zeros_like(RECALL_POINTS)
            aps.append(p.mean())
        ap_per_class.append(float(np.mean(aps)))
        ap50_per_class.append(float(aps[0]))
        ap75_per_class.append(float(aps[5]))

    if not ap_per_class:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
    return {
        "AP": float(np.mean(ap_per_class)),
        "AP50": float(np.mean(ap50_per_class)),
        "AP75": float(np.mean(ap75_per_class)),
    }
