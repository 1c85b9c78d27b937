"""ctypes bindings of the native host ops (``trcnn_torch/native/
detection_ops.cc``), the port's counterpart of ``trcnn/ops/native.py``.

The library is C++ on the host with a plain C interface: greedy NMS, the
pairwise IoU matrix and Caffe's RoI max-pool forward, with the +1 pixel
convention.  It is built at first use with ``g++`` through
``trcnn_torch/native/Makefile`` into ``build/native/<hash>/libdetops.so``
at the repository root (``<hash>`` covers the source and the Makefile),
never into the source directory.  :func:`available` says whether it built
and loaded; when it cannot be built, each op raises with the compiler's
message.  The ops never fall back: ``nms_plain``, ``bbox_overlaps_plain``
and ``roi_max_pool_plain`` are the same functions on the port's plain
PyTorch versions (CPU tensors), for callers and tests that want them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from trcnn_torch.ops import roi_pool
from trcnn_torch.ops.boxes import box_iou
from trcnn_torch.ops.nms import greedy_keep_plain

SRC_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def source_hash() -> str:
    h = hashlib.sha256()
    for name in ("detection_ops.cc", "Makefile"):
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libdetops.so"


def _build(so: Path) -> None:
    """make the library into ``so`` (through a file of this process's own,
    renamed into place, so that concurrent builds do not collide)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f".libdetops.{os.getpid()}.so"
    try:
        proc = subprocess.run(["make", "-s", "-C", str(SRC_DIR), f"OUT={tmp}"],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"could not run make for {SRC_DIR}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed (make exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises with the build's
    message (kept for later calls) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        so = library_path()
        try:
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            raise RuntimeError(_error) from e
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.nms_sorted.argtypes = [f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int, i32p]
        lib.nms_sorted.restype = ctypes.c_int
        lib.bbox_overlaps.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
        lib.bbox_overlaps.restype = None
        lib.roi_max_pool.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
                                     ctypes.c_int, ctypes.c_float, ctypes.c_int, f32p]
        lib.roi_max_pool.restype = None
        _lib = lib
        return lib


def _boxes(a: np.ndarray, what: str) -> np.ndarray:
    """``a`` as a C-contiguous float32 (N, 4) array, or a ValueError: the
    library reads 4 floats a box through a bare pointer."""
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"{what}: expected (N, 4) boxes, got shape {a.shape}")
    return a


def available() -> bool:
    """Whether the library builds and loads here (the first call builds)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def nms_cpu(boxes: np.ndarray, scores: np.ndarray, thresh: float,
            max_out: Optional[int] = None) -> List[int]:
    """Greedy NMS, the reference's cpu_nms semantics (IoU > thresh
    suppresses): the kept indices into the inputs, in score order (ties to
    the lower index)."""
    lib = _load()
    boxes = _boxes(boxes, "nms_cpu")
    n = len(boxes)
    if np.shape(scores) != (n,):
        raise ValueError(f"nms_cpu: {n} boxes but scores of shape {np.shape(scores)}")
    max_out = n if max_out is None else max_out
    order = np.argsort(-np.asarray(scores), kind="stable")
    keep = np.empty(n, np.int32)
    k = lib.nms_sorted(np.ascontiguousarray(boxes[order]), n, float(thresh), int(max_out), keep)
    return [int(order[i]) for i in keep[:k]]


def bbox_overlaps_cpu(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, K) float32 pairwise IoU, the reference's bbox_overlaps
    semantics."""
    lib = _load()
    boxes, query = _boxes(boxes, "bbox_overlaps_cpu"), _boxes(query, "bbox_overlaps_cpu")
    out = np.empty((len(boxes), len(query)), np.float32)
    lib.bbox_overlaps(boxes, len(boxes), query, len(query), out)
    return out


def roi_max_pool_cpu(feat: np.ndarray, rois: np.ndarray, out_size: int = 7,
                     spatial_scale: float = 1.0 / 16.0) -> np.ndarray:
    """(R, out_size, out_size, C) Caffe RoI pooling forward of (H, W, C)
    features, empty bins 0."""
    lib = _load()
    feat = np.ascontiguousarray(feat, np.float32)
    rois = _boxes(rois, "roi_max_pool_cpu")
    if feat.ndim != 3:
        raise ValueError(f"roi_max_pool_cpu: expected (H, W, C) features, got {feat.shape}")
    h, w, c = feat.shape
    r = len(rois)
    out = np.empty((r, out_size, out_size, c), np.float32)
    lib.roi_max_pool(feat, h, w, c, rois, r, float(spatial_scale), int(out_size), out)
    return out


def nms_plain(boxes: np.ndarray, scores: np.ndarray, thresh: float,
              max_out: Optional[int] = None) -> List[int]:
    """:func:`nms_cpu` on the port's plain greedy NMS (its division-free
    IoU predicate)."""
    boxes = np.asarray(boxes, np.float32)
    n = len(boxes)
    max_out = n if max_out is None else max_out
    order = np.argsort(-np.asarray(scores), kind="stable")
    pos, ok = greedy_keep_plain(torch.from_numpy(np.ascontiguousarray(boxes[order])),
                                torch.ones(n, dtype=torch.bool), float(thresh), max_out)
    return [int(order[p]) for p in pos[ok].tolist()]


def bbox_overlaps_plain(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """:func:`bbox_overlaps_cpu` on the port's ``box_iou``."""
    return box_iou(torch.from_numpy(np.asarray(boxes, np.float32)),
                   torch.from_numpy(np.asarray(query, np.float32))).numpy()


def roi_max_pool_plain(feat: np.ndarray, rois: np.ndarray, out_size: int = 7,
                       spatial_scale: float = 1.0 / 16.0) -> np.ndarray:
    """:func:`roi_max_pool_cpu` on the port's plain RoI max-pool."""
    out = roi_pool.roi_max_pool_plain(torch.from_numpy(np.asarray(feat, np.float32))[None],
                                      torch.from_numpy(np.asarray(rois, np.float32))[None],
                                      out_size, spatial_scale)
    return out[0].numpy()
