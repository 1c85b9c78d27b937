"""Anchor generation (port of ``trcnn/ops/anchors.py``).

The 9 base anchors (base 16, ratios (0.5, 1, 2) x scales (8, 16, 32), "+1"
pixel convention) are restated here in numpy: ``trcnn.ops.anchors`` cannot
be imported without JAX.  The grid enumeration is grid position major
(row-major over y, x), anchor index minor — the order of the RPN outputs'
(H, W, A) reshape.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from trcnn_torch.config import AnchorConfig


def _whctrs(anchor: np.ndarray) -> Tuple[float, float, float, float]:
    w = anchor[2] - anchor[0] + 1.0
    h = anchor[3] - anchor[1] + 1.0
    return w, h, anchor[0] + 0.5 * (w - 1.0), anchor[1] + 0.5 * (h - 1.0)


def _mkanchors(ws, hs, x_ctr, y_ctr) -> np.ndarray:
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1.0), y_ctr - 0.5 * (hs - 1.0),
                      x_ctr + 0.5 * (ws - 1.0), y_ctr + 0.5 * (hs - 1.0)))


def generate_base_anchors(base_size: int = 16,
                          ratios: Sequence[float] = (0.5, 1.0, 2.0),
                          scales: Sequence[float] = (8.0, 16.0, 32.0)
                          ) -> np.ndarray:
    """The (A, 4) float32 base anchors centred on a base_size cell; with the
    defaults the first is (-84, -40, 99, 55)."""
    base = np.array([0, 0, base_size - 1, base_size - 1], dtype=np.float64)
    w, h, x_ctr, y_ctr = _whctrs(base)
    ws = np.round(np.sqrt(w * h / np.asarray(ratios, np.float64)))
    hs = np.round(ws * np.asarray(ratios, np.float64))
    s = np.asarray(scales, np.float64)
    out = []
    for ra in _mkanchors(ws, hs, x_ctr, y_ctr):
        w, h, x_ctr, y_ctr = _whctrs(ra)
        out.append(_mkanchors(w * s, h * s, x_ctr, y_ctr))
    return np.vstack(out).astype(np.float32)


def shifted_anchors(feat_h: int, feat_w: int,
                    cfg: AnchorConfig = AnchorConfig(),
                    device=None) -> torch.Tensor:
    """All (feat_h * feat_w * A, 4) float32 anchors over the feature grid.

    The result is cached per (grid, config, device) and shared: callers
    must not modify it.  A copy from pageable host memory synchronises the
    stream, so it is made once, not on every image.
    """
    return _shifted_anchors_cached(feat_h, feat_w, cfg, torch.device(device or "cpu"))


@lru_cache(maxsize=16)
def _shifted_anchors_cached(feat_h: int, feat_w: int, cfg: AnchorConfig,
                            device: torch.device) -> torch.Tensor:
    base = torch.from_numpy(
        generate_base_anchors(cfg.base_size, cfg.ratios, cfg.scales)).to(device)
    shift_x = torch.arange(feat_w, dtype=torch.float32, device=device) * cfg.feat_stride
    shift_y = torch.arange(feat_h, dtype=torch.float32, device=device) * cfg.feat_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1),
                          sx.reshape(-1), sy.reshape(-1)], dim=1)
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
