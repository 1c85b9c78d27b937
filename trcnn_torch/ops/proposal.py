"""Proposal layer for one image (port of ``trcnn/ops/proposal.py``).

Decode the RPN deltas on the anchors, clip to the valid image, drop boxes
under ``min_size * im_scale`` and grid positions beyond the valid feature
extent of the padded canvas, keep the top ``pre_nms_topk`` by a stable sort,
and run greedy NMS (kernel K1 on the card) down to ``post_nms_topk``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trcnn_torch.config import AnchorConfig, ProposalConfig
from trcnn_torch.ops.anchors import shifted_anchors
from trcnn_torch.ops.boxes import bbox_transform_inv, clip_boxes
from trcnn_torch.ops.nms import nms_padded
from trcnn_torch.ops.topk import masked_topk_payload


class Proposals(NamedTuple):
    rois: torch.Tensor       # (post_nms_topk, 4) image coords
    scores: torch.Tensor     # (post_nms_topk,)
    valid: torch.Tensor      # (post_nms_topk,) bool


def proposal_layer(rpn_fg_probs: torch.Tensor, rpn_deltas: torch.Tensor,
                   im_h, im_w, im_scale, train: bool,
                   anchor_cfg: AnchorConfig = AnchorConfig(),
                   cfg: ProposalConfig = ProposalConfig()) -> Proposals:
    """rpn_fg_probs (fH, fW, A), rpn_deltas (fH, fW, A, 4) or (fH, fW, 4A);
    ``im_h``/``im_w``/``im_scale`` are numbers or 0-d tensors."""
    fh, fw, a = rpn_fg_probs.shape
    dev = rpn_fg_probs.device
    anchors = shifted_anchors(fh, fw, anchor_cfg, device=dev)
    deltas = rpn_deltas.reshape(-1, 4)
    scores = rpn_fg_probs.reshape(-1)

    proposals = clip_boxes(bbox_transform_inv(anchors, deltas), im_h, im_w)

    min_size = cfg.min_size * torch.as_tensor(im_scale, dtype=torch.float32, device=dev)
    ws = proposals[:, 2] - proposals[:, 0] + 1.0
    hs = proposals[:, 3] - proposals[:, 1] + 1.0
    size_ok = (ws >= min_size) & (hs >= min_size)

    # padded-canvas guard: grid positions past the valid feature extent see
    # only zero padding
    stride = anchor_cfg.feat_stride
    valid_fh = torch.ceil(torch.as_tensor(im_h, dtype=torch.float32, device=dev) / stride)
    valid_fw = torch.ceil(torch.as_tensor(im_w, dtype=torch.float32, device=dev) / stride)
    gy = torch.arange(fh, device=dev)
    gx = torch.arange(fw, device=dev)
    grid_ok = (gy[:, None] < valid_fh.to(torch.int32)) & (gx[None, :] < valid_fw.to(torch.int32))
    grid_ok = grid_ok.reshape(-1).repeat_interleave(a)

    pre_k = min(cfg.pre_nms_topk(train), scores.shape[0])
    top_scores, (px1, py1, px2, py2), top_valid = masked_topk_payload(
        scores, size_ok & grid_ok, pre_k,
        proposals[:, 0], proposals[:, 1], proposals[:, 2], proposals[:, 3])
    top_boxes = torch.stack([px1, py1, px2, py2], dim=-1)

    keep_idx, keep_valid = nms_padded(top_boxes, top_scores, top_valid,
                                      cfg.nms_thresh, cfg.post_nms_topk(train),
                                      presorted=True)
    k = keep_idx.long()
    rois = torch.where(keep_valid[:, None], top_boxes[k], 0.0)
    roi_scores = torch.where(keep_valid, top_scores[k], 0.0)
    return Proposals(rois=rois, scores=roi_scores, valid=keep_valid)
