"""RoI head target assignment (port of
``trcnn/targets/proposal_targets.py``).

Append the gt boxes to the proposals; sample ``rois_per_image`` RoIs:
foreground (IoU >= 0.5) up to 25%, background with IoU in [0.1, 0.5)
filling the rest, each by ranking iid uniforms.  The selected candidates
are compacted into the output slots by a stable sort on one priority key
(foreground in rank order, then background).  Slots left over cycle the
selected background samples (the foreground ones when there is no
background); an image with no candidate at all has every slot invalid.
Regression targets are normalised by the configured means and stds.

The uniforms are arguments, as in :mod:`trcnn_torch.targets.anchor_targets`;
the per-image inputs take optional leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trcnn_torch.config import ProposalTargetConfig
from trcnn_torch.ops.boxes import bbox_transform, box_iou, device_constant
from trcnn_torch.targets.anchor_targets import gather_rows, random_rank


class ProposalTargets(NamedTuple):
    rois: torch.Tensor          # (..., S, 4) sampled boxes, image coords
    labels: torch.Tensor        # (..., S) int32 class ids, 0 = background
    bbox_targets: torch.Tensor  # (..., S, 4) normalised targets, fg rows
    is_fg: torch.Tensor         # (..., S) bool
    valid: torch.Tensor         # (..., S) bool: the slot holds a sample
    num_fg: torch.Tensor        # (...,) int32


def proposal_targets(rois: torch.Tensor, roi_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, u_fg: torch.Tensor, u_bg: torch.Tensor,
                     cfg: ProposalTargetConfig = ProposalTargetConfig()
                     ) -> ProposalTargets:
    """rois (..., P, 4), roi_valid (..., P); gt_boxes (..., G, 4), gt_labels
    (..., G) (1..C-1), gt_valid (..., G); u_fg, u_bg (..., P + G) uniforms
    in [0, 1) over the candidates (proposals, then gt)."""
    s = cfg.rois_per_image
    fg_cap = int(round(cfg.fg_fraction * s))
    dev = rois.device

    cand = torch.cat([rois, gt_boxes], dim=-2)                # (..., n, 4)
    cand_valid = torch.cat([roi_valid, gt_valid], dim=-1)
    n = cand.shape[-2]
    iou = torch.where(gt_valid[..., None, :], box_iou(cand, gt_boxes), 0.0)
    max_iou = iou.amax(-1)
    argmax_gt = iou.argmax(-1)

    fg = cand_valid & (max_iou >= cfg.fg_iou)
    bg = cand_valid & (max_iou < cfg.bg_iou_hi) & (max_iou >= cfg.bg_iou_lo)
    fg_rank = random_rank(u_fg, fg)
    sel_fg = fg & (fg_rank < fg_cap)
    num_fg = sel_fg.sum(-1, dtype=torch.int32)
    bg_rank = random_rank(u_bg, bg)
    sel_bg = bg & (bg_rank < (s - num_fg)[..., None])
    num_sel = num_fg + sel_bg.sum(-1, dtype=torch.int32)

    # compact into S slots: selected fg in rank order, then selected bg
    key = torch.where(sel_fg, fg_rank, torch.where(sel_bg, n + bg_rank, 2 * n + 1))
    order = torch.argsort(key, dim=-1, stable=True)
    num_fg_, num_sel_ = num_fg[..., None], num_sel[..., None]
    num_bg = num_sel_ - num_fg_
    slot = torch.arange(s, device=dev)
    over = slot - num_sel_                                    # >= 0 on the tail
    bg_fill = num_fg_ + torch.where(num_bg > 0, over % num_bg.clamp(min=1), 0)
    fg_fill = torch.where(num_fg_ > 0, over % num_fg_.clamp(min=1), 0)
    fill = torch.where(num_bg > 0, bg_fill, fg_fill)
    src_slot = torch.where(over >= 0, fill, slot)
    take = torch.gather(order, -1, src_slot.clamp(0, n - 1))  # (..., S)
    slot_valid = (num_sel_ > 0).expand(take.shape)

    out_rois = gather_rows(cand, take)
    out_arg = torch.gather(argmax_gt, -1, take)
    out_is_fg = torch.gather(sel_fg, -1, take)
    labels = torch.where(out_is_fg, torch.gather(gt_labels.to(torch.int32), -1, out_arg), 0)

    targets = bbox_transform(out_rois, gather_rows(gt_boxes, out_arg))
    means = device_constant(tuple(cfg.bbox_normalize_means), dev)
    stds = device_constant(tuple(cfg.bbox_normalize_stds), dev)
    targets = torch.where(out_is_fg[..., None], (targets - means) / stds, 0.0)

    return ProposalTargets(
        rois=torch.where(slot_valid[..., None], out_rois, 0.0),
        labels=torch.where(slot_valid, labels, 0).to(torch.int32),
        bbox_targets=targets,
        is_fg=out_is_fg & slot_valid,
        valid=slot_valid,
        num_fg=num_fg)
