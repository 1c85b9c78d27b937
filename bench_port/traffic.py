"""The one traffic generator: a resident pool of batches on the card, made
from a workload file's parameters and the run's seed.

Every seed gets the same multiset of image sizes and gt counts (a fixed
lattice of quantiles of the stated distributions), in another order; the
seed draws that order, the pixels, the gt boxes and their classes.  So two
seeds do the same amount of work, and one seed always makes the same
inputs.

Image sizes follow the detector's resize rule: an original of
``orig_short`` pixels on its short side and ``aspect`` (long / short,
landscape) is scaled so that its short side is ``min_size`` (one of
``multiscale`` per image when given) unless its long side would pass
``max_size``; ``im_info`` is (scaled_h, scaled_w, im_scale) and the
scaled image fills the top-left of the canvas.  Pixels are uniform uint8
inside the image and zero outside.  gt boxes lie inside the scaled image,
with sides uniform in [``side_lo``, ``side_hi``] of the image's, classes
uniform over the foreground classes; an image's count is drawn from
``counts`` ({count: weight}), capped at the config's capacity.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch


def lattice(n: int, lo: float, hi: float) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def quantiles(n: int, weights: Mapping[str, float]) -> np.ndarray:
    """n values whose shares follow ``weights`` ({value: weight}): value v
    takes the lattice points (i + 0.5) / n inside its stretch of the CDF."""
    vals = np.array(sorted(int(k) for k in weights), np.int64)
    w = np.array([weights[str(v)] for v in vals], np.float64)
    cdf = np.cumsum(w / w.sum())
    return vals[np.minimum(np.searchsorted(cdf, (np.arange(n) + 0.5) / n), len(vals) - 1)]


def im_info_rows(image: Mapping, n: int, order: np.ndarray) -> np.ndarray:
    """(n, 3) float32 im_info rows: a fixed lattice of aspects, each paired
    with a shorter-side target in turn, the rows taken in ``order``."""
    aspect = lattice(n, *image["aspect"])
    sizes = image.get("multiscale") or [image["min_size"]]
    mins = np.asarray([sizes[i % len(sizes)] for i in range(n)], np.float64)
    short, long_ = float(image["orig_short"]), float(image["orig_short"]) * aspect
    scale = np.minimum(mins / short, image["max_size"] / long_)
    rows = np.stack([np.round(short * scale), np.round(long_ * scale), scale], 1)
    return rows.astype(np.float32)[order]


def make_pool(traffic: Mapping, cfg, batch: int, gt_capacity: int, seed: int, device
              ) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool_batches"]`` batches of ``batch`` images on ``device``:
    images (B, H, W, 3) uint8 and im_info (B, 3); with a ``gt`` section also
    gt_boxes (B, G, 4), gt_labels (B, G) int32 and gt_valid (B, G)."""
    nb = traffic["pool_batches"]
    n = nb * batch
    h, w = cfg.image.pad_h, cfg.image.pad_w
    rng = np.random.default_rng(seed)
    info = im_info_rows(traffic["image"], n, rng.permutation(n))
    if (info[:, 0] > h).any() or (info[:, 1] > w).any():
        raise ValueError(f"an image of {info[:, :2].max(0)} exceeds the {h}x{w} canvas")
    gen = torch.Generator(device=device).manual_seed(seed)
    pixels = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=gen, device=device)
    info_t = torch.from_numpy(info).to(device)
    yy = torch.arange(h, device=device)[None, :, None, None]
    xx = torch.arange(w, device=device)[None, None, :, None]
    inside = (yy < info_t[:, 0, None, None, None]) & (xx < info_t[:, 1, None, None, None])
    pixels.mul_(inside)
    del inside
    gt = traffic.get("gt")
    if gt is not None:
        counts = np.minimum(quantiles(n, gt["counts"])[rng.permutation(n)], gt_capacity)
        side = rng.uniform(gt["side_lo"], gt["side_hi"], (n, gt_capacity, 2))
        corner = rng.uniform(0.0, 1.0, (n, gt_capacity, 2))
        ext = info[:, None, 1::-1]                                  # (n, 1, (w, h))
        size = side * ext
        x1y1 = corner * (ext - 1.0 - size)
        boxes = np.concatenate([x1y1, x1y1 + size], -1).astype(np.float32)
        valid = np.arange(gt_capacity)[None, :] < counts[:, None]
        labels = rng.integers(1, cfg.num_classes, (n, gt_capacity)).astype(np.int32)
        gt_t = {"gt_boxes": torch.from_numpy(np.where(valid[..., None], boxes, 0)),
                "gt_labels": torch.from_numpy(np.where(valid, labels, 0).astype(np.int32)),
                "gt_valid": torch.from_numpy(valid)}
    pool = []
    for i in range(nb):
        sl = slice(i * batch, (i + 1) * batch)
        item = {"images": pixels[sl], "im_info": info_t[sl]}
        if gt is not None:
            item.update({k: v[sl].to(device) for k, v in gt_t.items()})
        pool.append(item)
    return pool


def summary(pool: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, float]:
    """The pool's image sizes and gt counts, for the record."""
    info = torch.cat([b["im_info"] for b in pool]).cpu()
    out = {"images": int(info.shape[0]), "scaled_h_mean": float(info[:, 0].mean()),
           "scaled_w_mean": float(info[:, 1].mean())}
    if "gt_valid" in pool[0]:
        out["gt_per_image_mean"] = float(torch.cat([b["gt_valid"] for b in pool]).sum(-1)
                                         .float().mean())
    return out
