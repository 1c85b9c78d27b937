"""RPN anchor target assignment (port of ``trcnn/targets/anchor_targets.py``).

Keep inside-image anchors (allowed_border 0); an anchor is positive if its
IoU with some gt is >= 0.7 or it is a per-gt argmax (every tying anchor
counts); negative if its max IoU is < 0.3; else ignored (-1).  Subsample to
256 with at most 50% foreground by ranking iid uniforms: only the members
whose random rank is below the quota keep their label.  Labels stay on the
full anchor grid, so every shape is static.

The uniforms are arguments: the caller draws them from an explicit
``torch.Generator`` (or hands in the JAX package's draws, as the tests do).
Every function takes optional leading batch dimensions on the per-image
inputs; the anchors are shared.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trcnn_torch.config import AnchorTargetConfig
from trcnn_torch.ops.boxes import bbox_transform, box_iou


class AnchorTargets(NamedTuple):
    labels: torch.Tensor        # (..., N) int32: 1 fg, 0 bg, -1 ignore
    bbox_targets: torch.Tensor  # (..., N, 4) float32, zero where not fg
    num_examples: torch.Tensor  # (...,) int32: count of labels >= 0
    num_fg: torch.Tensor        # (...,) int32


def random_rank(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0-based rank of each member of ``mask`` in the order of ``u`` (a
    stable sort: equal draws keep index order); non-members rank after
    every member."""
    order = torch.argsort(torch.where(mask, u, 2.0), dim=-1, stable=True)
    pos = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., M, D), idx (..., K) with the same leading dims -> (..., K, D):
    rows of x along dim -2 (``jnp.take(x, idx, axis=-2)`` per image)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def anchor_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, im_h, im_w, u_fg: torch.Tensor,
                   u_bg: torch.Tensor,
                   cfg: AnchorTargetConfig = AnchorTargetConfig()) -> AnchorTargets:
    """anchors (N, 4); gt_boxes (..., G, 4), gt_valid (..., G); im_h, im_w
    numbers or (...,) tensors, the scaled image extent; u_fg, u_bg (..., N)
    uniforms in [0, 1) for the foreground and background draws."""
    dev = anchors.device
    im_h = torch.as_tensor(im_h, dtype=torch.float32, device=dev)[..., None]
    im_w = torch.as_tensor(im_w, dtype=torch.float32, device=dev)[..., None]
    ab = cfg.allowed_border
    inside = ((anchors[:, 0] >= -ab) & (anchors[:, 1] >= -ab)
              & (anchors[:, 2] < im_w + ab) & (anchors[:, 3] < im_h + ab))

    any_gt = gt_valid.any(-1, keepdim=True)
    iou = box_iou(anchors, gt_boxes)                          # (..., N, G)
    iou = torch.where(gt_valid[..., None, :], iou, 0.0)
    iou = torch.where(inside[..., None], iou, 0.0)
    max_iou = iou.amax(-1)
    argmax_gt = iou.argmax(-1)                                # first of ties

    # per-gt argmax anchors, every tie included
    gt_max = iou.amax(-2, keepdim=True)                       # (..., 1, G)
    is_gt_argmax = ((iou == gt_max) & (gt_max > 0) & gt_valid[..., None, :]).any(-1)

    neg = inside & (max_iou < cfg.negative_iou)
    pos = inside & (is_gt_argmax | (max_iou >= cfg.positive_iou)) & any_gt
    if not cfg.clobber_positives:
        neg = neg & ~pos
    else:
        pos = pos & ~(max_iou < cfg.negative_iou)

    fg_cap = int(cfg.fg_fraction * cfg.batch_size)
    pos = pos & (random_rank(u_fg, pos) < fg_cap)
    num_fg = pos.sum(-1, dtype=torch.int32)
    bg_quota = cfg.batch_size - num_fg
    neg = neg & (random_rank(u_bg, neg) < bg_quota[..., None])
    num_examples = num_fg + neg.sum(-1, dtype=torch.int32)

    labels = torch.where(pos, 1, torch.where(neg, 0, -1)).to(torch.int32)
    matched = gather_rows(gt_boxes, argmax_gt)                # (..., N, 4)
    bbox_targets = torch.where(pos[..., None], bbox_transform(anchors, matched), 0.0)
    return AnchorTargets(labels=labels, bbox_targets=bbox_targets,
                         num_examples=num_examples, num_fg=num_fg)
