"""PASCAL VOC detection AP: the port's copy of ``trcnn/eval/voc_ap.py``
(numpy only).

The VOC devkit protocol of the py-faster-rcnn lineage: per class,
detections ranked by score are matched greedily to ground truth at IoU
strictly above 0.5 (+1-pixel convention), each gt at most once, difficult
gt neither scored nor penalised; AP by 11-point interpolation (the VOC2007
metric) or as the area under the monotone precision envelope (VOC2010+).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DetectionRecord:
    """All detections and ground truth of one class over a dataset."""

    image_ids: List[str]
    scores: np.ndarray                    # (D,)
    boxes: np.ndarray                     # (D, 4)
    gt_boxes: Dict[str, np.ndarray]       # id -> (Gi, 4)
    gt_difficult: Dict[str, np.ndarray]   # id -> (Gi,) bool


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = True) -> float:
    """AP from a PR curve: the 07 metric averages the best precision at
    recall >= t over t = 0, 0.1, ..., 1.0; otherwise the area under the
    monotone envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """+1-convention IoU of one box with (G, 4)."""
    iw = np.maximum(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]) + 1.0, 0.0)
    ih = np.maximum(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]) + 1.0, 0.0)
    inter = iw * ih
    a1 = (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    union = a1 + a2 - inter
    return np.where(union > 0, inter / union, 0.0)


def voc_eval_class(rec: DetectionRecord, iou_thresh: float = 0.5, use_07_metric: bool = True
                   ) -> Tuple[float, np.ndarray, np.ndarray]:
    """One class -> (ap, recall curve, precision curve)."""
    npos = sum(int((~d).sum()) for d in rec.gt_difficult.values())
    order = np.argsort(-np.asarray(rec.scores), kind="stable")
    image_ids = [rec.image_ids[i] for i in order]
    boxes = np.asarray(rec.boxes, np.float64)[order]
    matched = {k: np.zeros(len(v), bool) for k, v in rec.gt_boxes.items()}
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        iid = image_ids[d]
        gtb = rec.gt_boxes.get(iid)
        if gtb is None or len(gtb) == 0:
            fp[d] = 1.0
            continue
        ious = _iou_one_to_many(boxes[d], np.asarray(gtb, np.float64))
        j = int(np.argmax(ious))
        if ious[j] > iou_thresh:               # the devkit's strict ovmax > thresh
            if rec.gt_difficult[iid][j]:
                continue                       # difficult: ignored
            if not matched[iid][j]:
                matched[iid][j] = True
                tp[d] = 1.0
            else:
                fp[d] = 1.0                    # duplicate detection
        else:
            fp[d] = 1.0
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / max(npos, 1)
    precision = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
    return voc_ap(recall, precision, use_07_metric), recall, precision


def voc_mean_ap(records: Dict[str, DetectionRecord], iou_thresh: float = 0.5,
                use_07_metric: bool = True) -> Tuple[float, Dict[str, float]]:
    """mAP over {class name: DetectionRecord} -> (mean, {class: AP})."""
    aps = {name: voc_eval_class(rec, iou_thresh, use_07_metric)[0]
           for name, rec in records.items()}
    return (float(np.mean(list(aps.values()))) if aps else 0.0), aps


def build_records(class_names: Sequence[str], detections: List[dict],
                  annotations: Dict[str, dict]) -> Dict[str, DetectionRecord]:
    """DetectionRecords from per-image outputs.

    class_names: every class, "__background__" at 0.  detections: [{"id",
    "boxes" (D, 4), "scores" (D,), "classes" (D,)}].  annotations: {id:
    {"boxes" (G, 4), "labels" (G,), "difficult" (G,)}}.
    """
    records = {}
    for ci in range(1, len(class_names)):
        img_ids: List[str] = []
        scores: List[float] = []
        boxes: List[np.ndarray] = []
        for det in detections:
            m = np.asarray(det["classes"]) == ci
            img_ids += [det["id"]] * int(m.sum())
            scores += list(np.asarray(det["scores"])[m])
            boxes += list(np.asarray(det["boxes"])[m])
        gt_boxes, gt_diff = {}, {}
        for iid, ann in annotations.items():
            m = np.asarray(ann["labels"]) == ci
            gt_boxes[iid] = np.asarray(ann["boxes"])[m]
            diff = np.asarray(ann.get("difficult", np.zeros(len(ann["labels"]), bool)))
            gt_diff[iid] = diff[m].astype(bool)
        records[class_names[ci]] = DetectionRecord(
            image_ids=img_ids, scores=np.asarray(scores, np.float64),
            boxes=np.asarray(boxes, np.float64).reshape(-1, 4),
            gt_boxes=gt_boxes, gt_difficult=gt_diff)
    return records


def write_voc_detection_files(class_names: Sequence[str], detections: List[dict], out_dir: str,
                              split: str = "test", comp: str = "comp4") -> List[str]:
    """The VOC devkit's per-class detection files,
    ``<comp>_det_<split>_<class>.txt``, a line per detection: ``image_id
    score x1 y1 x2 y2`` in 1-based inclusive coordinates, as upstream
    test_net.py writes them for external re-scoring.  Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ci in range(1, len(class_names)):
        path = os.path.join(out_dir, f"{comp}_det_{split}_{class_names[ci]}.txt")
        with open(path, "w") as f:
            for det in detections:
                m = np.asarray(det["classes"]) == ci
                boxes = np.asarray(det["boxes"], np.float64)[m]
                scores = np.asarray(det["scores"], np.float64)[m]
                for b, s in zip(boxes, scores):
                    f.write(f"{det['id']} {s:.3f} {b[0] + 1:.1f} "
                            f"{b[1] + 1:.1f} {b[2] + 1:.1f} {b[3] + 1:.1f}\n")
        paths.append(path)
    return paths
