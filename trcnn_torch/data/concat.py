"""Dataset concatenation (the VOC07+12 union): the port's copy of
``trcnn/data/concat.py``.

An index-space concatenation of datasets with the VOCDetection protocol;
ids are prefixed with the part index ("0:000005") so that they stay unique
when two parts share an id scheme (the evaluator keys detections by id).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class ConcatDetection:
    def __init__(self, parts: Sequence):
        if not parts:
            raise ValueError("ConcatDetection needs at least one dataset")
        self.parts = list(parts)
        self._offsets: List[int] = []
        total = 0
        for p in self.parts:
            self._offsets.append(total)
            total += len(p)
        self._total = total
        self.ids = [f"{pi}:{ex_id}" for pi, p in enumerate(self.parts)
                    for ex_id in getattr(p, "ids", range(len(p)))]

    def __len__(self) -> int:
        return self._total

    def _locate(self, i: int) -> Tuple[int, int]:
        if not 0 <= i < self._total:
            raise IndexError(i)
        for pi in range(len(self.parts) - 1, -1, -1):
            if i >= self._offsets[pi]:
                return pi, i - self._offsets[pi]
        raise IndexError(i)

    def _prefixed(self, i: int, what: str) -> dict:
        pi, j = self._locate(i)
        ex = dict(getattr(self.parts[pi], what)(j))
        ex["id"] = f"{pi}:{ex['id']}"
        return ex

    def get_example(self, i: int) -> dict:
        return self._prefixed(i, "get_example")

    def get_annotation(self, i: int) -> dict:
        return self._prefixed(i, "get_annotation")

    def get_size(self, i: int):
        pi, j = self._locate(i)
        return self.parts[pi].get_size(j)

    __getitem__ = get_example
