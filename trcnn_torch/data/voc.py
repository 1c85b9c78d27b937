"""PASCAL VOC detection dataset: the port's copy of ``trcnn/data/voc.py``.

VOCdevkit layout: ``root/JPEGImages/<id>.jpg``,
``root/Annotations/<id>.xml``, ``root/ImageSets/Main/<split>.txt``.
Examples follow the Chainer dataset protocol of the reference
(``get_example(i)``, ``__len__``); batching lives in
:class:`trcnn_torch.data.loader.DetectionLoader`.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

from trcnn_torch.config import VOC_CLASSES
from trcnn_torch.data.image import read_image

_CLASS_TO_ID: Dict[str, int] = {n: i for i, n in enumerate(VOC_CLASSES)}


def parse_voc_xml(path: str, use_difficult: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One annotation file -> (boxes (G, 4) float32, labels (G,) int32,
    difficult (G,) bool).

    VOC's coordinates are 1-based and inclusive; the py-faster-rcnn lineage
    subtracts 1 for 0-based (x1, y1, x2, y2).  Difficult objects are skipped
    unless ``use_difficult`` (evaluation loads them, so that the AP code can
    ignore them without penalty); unknown class names are skipped.
    """
    tree = ET.parse(path)
    boxes: List[List[float]] = []
    labels: List[int] = []
    difficult: List[bool] = []
    for obj in tree.findall("object"):
        diff = obj.find("difficult")
        is_diff = diff is not None and int(diff.text) == 1
        if not use_difficult and is_diff:
            continue
        name = obj.find("name").text.lower().strip()
        if name not in _CLASS_TO_ID:
            continue
        bb = obj.find("bndbox")
        boxes.append([float(bb.find(k).text) - 1.0 for k in ("xmin", "ymin", "xmax", "ymax")])
        labels.append(_CLASS_TO_ID[name])
        difficult.append(is_diff)
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), np.zeros((0,), bool)
    return (np.asarray(boxes, np.float32), np.asarray(labels, np.int32),
            np.asarray(difficult, bool))


class VOCDetection:
    """``get_example(i)`` -> {"image" (H, W, 3) uint8 BGR, "boxes" (G, 4)
    float32, "labels" (G,) int32, "difficult" (G,) bool, "id" str}."""

    def __init__(self, root: str, split: str = "trainval", use_difficult: bool = False):
        self.root = root
        self.split = split
        self.use_difficult = use_difficult
        with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt")) as f:
            self.ids = [line.strip().split()[0] for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def _xml(self, i: int) -> str:
        return os.path.join(self.root, "Annotations", f"{self.ids[i]}.xml")

    def get_example(self, i: int) -> dict:
        img = read_image(os.path.join(self.root, "JPEGImages", f"{self.ids[i]}.jpg"))
        return {"image": img, **self.get_annotation(i)}

    def get_size(self, i: int) -> Tuple[int, int]:
        """(height, width) from the XML's <size>, with no image decode: the
        sharded loader's bucket schedule needs it."""
        sz = ET.parse(self._xml(i)).find("size")
        return int(sz.find("height").text), int(sz.find("width").text)

    def get_annotation(self, i: int) -> dict:
        """The example without its image (the evaluator's ground truth)."""
        boxes, labels, difficult = parse_voc_xml(self._xml(i), self.use_difficult)
        return {"boxes": boxes, "labels": labels, "difficult": difficult, "id": self.ids[i]}

    __getitem__ = get_example
