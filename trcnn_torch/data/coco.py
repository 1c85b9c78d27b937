"""COCO detection dataset: the port's copy of ``trcnn/data/coco.py``.

Reads a COCO ``instances_*.json`` itself (no pycocotools): images,
annotations and categories; boxes from COCO's (x, y, w, h) to the
pipeline's inclusive (x1, y1, x2, y2) with x2 = x + w - 1; crowd regions
flagged.  It has the VOCDetection protocol, so the same loader, trainer
and evaluator drive it.  Images go through ``data/image.py`` (cv2, else
PIL).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from trcnn_torch.data.image import read_image


class COCODetection:
    """COCO instances dataset.

    image_root: the directory of the image files (e.g. ``train2017/``).
    ann_file: the instances json.  use_crowd: keep ``iscrowd=1`` boxes
    (evaluation flags them so the AP ignores them; training skips them).

    ``get_example(i)`` -> {"image" (H, W, 3) uint8 BGR, "boxes" (G, 4)
    float32, "labels" (G,) int32 contiguous ids 1..80 in category-id
    order, "difficult" (G,) bool (= iscrowd), "id" str}.
    """

    def __init__(self, image_root: str, ann_file: str, use_crowd: bool = False):
        self.image_root = image_root
        self.use_crowd = use_crowd
        with open(ann_file) as f:
            data = json.load(f)
        # COCO's category ids are sparse (80 of 1..90): contiguous labels
        # follow the ids' order
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in cats]
        self.class_names = ("__background__",) + tuple(c["name"] for c in cats)
        self._cat_to_label = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}
        self._images: Dict[int, dict] = {im["id"]: im for im in data["images"]}
        self._anns: Dict[int, List[dict]] = {i: [] for i in self._images}
        for a in data.get("annotations", []):
            if a["image_id"] in self._anns:
                self._anns[a["image_id"]].append(a)
        self.ids = sorted(self._images)

    def __len__(self) -> int:
        return len(self.ids)

    def get_example(self, i: int) -> dict:
        info = self._images[self.ids[i]]
        img = read_image(os.path.join(self.image_root, info["file_name"]))
        return {"image": img, **self.get_annotation(i)}

    def get_size(self, i: int) -> Tuple[int, int]:
        """(height, width) from the json, with no image decode."""
        info = self._images[self.ids[i]]
        return int(info["height"]), int(info["width"])

    def get_annotation(self, i: int) -> dict:
        """The example without its image (the evaluator's ground truth);
        boxes of no extent are dropped."""
        img_id = self.ids[i]
        boxes, labels, crowd = [], [], []
        for a in self._anns[img_id]:
            if a.get("iscrowd", 0) and not self.use_crowd:
                continue
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w - 1.0, y + h - 1.0])
            labels.append(self._cat_to_label[a["category_id"]])
            crowd.append(bool(a.get("iscrowd", 0)))
        g = len(boxes)
        return {"boxes": np.asarray(boxes, np.float32).reshape(g, 4),
                "labels": np.asarray(labels, np.int32),
                "difficult": np.asarray(crowd, bool), "id": str(img_id)}

    __getitem__ = get_example
