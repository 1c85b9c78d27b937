"""Synthetic detection dataset: the port's copy of
``trcnn/data/synthetic.py``, with the same draws for the same seed.

Seeded noise images with filled, class-coloured rectangles at the gt boxes,
so that a detector can fit it: tests, benchmarks and training runs need no
dataset on disk.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticDetection:
    """Deterministic random dataset with the VOCDetection protocol; image
    i draws from ``RandomState(seed * 100003 + i)``."""

    def __init__(self, n: int = 64, num_classes: int = 21, max_boxes: int = 6,
                 hw_range=((360, 600), (480, 800)), seed: int = 0):
        self.n = n
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.hw_range = hw_range
        self.seed = seed
        self.ids = [f"syn{i:06d}" for i in range(n)]

    def __len__(self) -> int:
        return self.n

    def _rng(self, i: int) -> np.random.RandomState:
        return np.random.RandomState(self.seed * 100003 + i)

    def _size(self, rng: np.random.RandomState) -> Tuple[int, int]:
        (h_lo, h_hi), (w_lo, w_hi) = self.hw_range
        h = int(rng.randint(h_lo, h_hi + 1))
        return h, int(rng.randint(w_lo, w_hi + 1))

    def get_size(self, i: int) -> Tuple[int, int]:
        """(height, width) without generating the image (the same draws)."""
        return self._size(self._rng(i))

    def get_example(self, i: int) -> dict:
        rng = self._rng(i)
        h, w = self._size(rng)
        img = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
        g = int(rng.randint(1, self.max_boxes + 1))
        x1 = rng.uniform(0, w * 0.6, g)
        y1 = rng.uniform(0, h * 0.6, g)
        bw = rng.uniform(0.15 * w, 0.4 * w, g)
        bh = rng.uniform(0.15 * h, 0.4 * h, g)
        x2 = np.minimum(x1 + bw, w - 1.0)
        y2 = np.minimum(y1 + bh, h - 1.0)
        boxes = np.stack([x1, y1, x2, y2], 1).astype(np.float32)
        labels = rng.randint(1, self.num_classes, size=g).astype(np.int32)
        for (a, b, c, d), lab in zip(boxes.astype(np.int32), labels):
            img[b:d + 1, a:c + 1] = ((lab * 37) % 256, (lab * 91) % 256, (lab * 157) % 256)
        return {"image": img, "boxes": boxes, "labels": labels, "id": self.ids[i]}

    def get_annotation(self, i: int) -> dict:
        ex = self.get_example(i)
        return {k: v for k, v in ex.items() if k != "image"}

    __getitem__ = get_example
