"""Image files in and out, through whichever library the machine has.

Decoding takes ``cv2`` when it imports (the decode the JAX package's
loader uses), else ``PIL``; without either, :func:`read_image` raises and
names both.  Drawing detections onto an image takes the same library.
Neither is imported before a function here needs it, so no module of the
port needs one to import.
"""

from __future__ import annotations

import importlib.util
from typing import Optional, Sequence

import numpy as np

LIBRARIES = ("cv2", "PIL")


def image_library() -> Optional[str]:
    """"cv2" or "PIL", the first of them that is installed, or None."""
    for name in LIBRARIES:
        if importlib.util.find_spec(name) is not None:
            return name
    return None


def _need_library() -> str:
    lib = image_library()
    if lib is None:
        raise RuntimeError("no image library: reading or writing an image file needs "
                           "OpenCV (cv2) or Pillow (PIL), and neither is installed")
    return lib


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8, BGR channel order."""
    if _need_library() == "cv2":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img
    from PIL import Image

    with Image.open(path) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[:, :, ::-1])


def write_detections(img_bgr: np.ndarray, boxes: np.ndarray, labels: Sequence[str],
                     path: str) -> None:
    """``img_bgr`` with each box drawn in red and labelled, written to
    ``path`` (the format from its suffix)."""
    if _need_library() == "cv2":
        import cv2

        img = img_bgr.copy()
        for (x1, y1, x2, y2), text in zip(boxes, labels):
            cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), (0, 0, 255), 2)
            cv2.putText(img, text, (int(x1), max(int(y1) - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (0, 0, 255), 1)
        if not cv2.imwrite(path, img):
            raise OSError(f"cannot write {path}")
        return
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1]))
    draw = ImageDraw.Draw(im)
    for (x1, y1, x2, y2), text in zip(boxes, labels):
        draw.rectangle([int(x1), int(y1), int(x2), int(y2)], outline=(255, 0, 0), width=2)
        draw.text((int(x1), max(int(y1) - 12, 0)), text, fill=(255, 0, 0))
    im.save(path)
