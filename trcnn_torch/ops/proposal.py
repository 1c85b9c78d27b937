"""Proposal layer, batched over images (port of ``trcnn/ops/proposal.py``
under ``jax.vmap``).

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
    rois: torch.Tensor       # (B, post_nms_topk, 4) image coords
    scores: torch.Tensor     # (B, post_nms_topk)
    valid: torch.Tensor      # (B, post_nms_topk) bool


def proposal_layer(rpn_fg_probs: torch.Tensor, rpn_deltas: torch.Tensor,
                   im_h, im_w, im_scale, train: bool,
                   anchor_cfg: AnchorConfig = AnchorConfig(),
                   cfg: ProposalConfig = ProposalConfig()) -> Proposals:
    """The proposal layer for a batch, as ``jax.vmap`` of the JAX function.

    rpn_fg_probs (B, fH, fW, A), rpn_deltas (B, fH, fW, A, 4) or
    (B, fH, fW, 4A); ``im_h``/``im_w``/``im_scale`` (B,) tensors on the
    scores' device.  One image may come without the batch axis, with
    numbers or 0-d tensors; its outputs then have none either.  Each
    image's guards broadcast over its boxes; one stable sort along the last
    axis and one NMS launch serve the whole batch.
    """
    if rpn_fg_probs.dim() == 3:
        dev = rpn_fg_probs.device
        info = [torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)
                for v in (im_h, im_w, im_scale)]
        p = proposal_layer(rpn_fg_probs[None], rpn_deltas[None], *info, train=train,
                           anchor_cfg=anchor_cfg, cfg=cfg)
        return Proposals(*(t[0] for t in p))
    b, fh, fw, a = rpn_fg_probs.shape
    dev = rpn_fg_probs.device
    anchors = shifted_anchors(fh, fw, anchor_cfg, device=dev)
    deltas = rpn_deltas.reshape(b, -1, 4)
    scores = rpn_fg_probs.reshape(b, -1)
    im_h = im_h.to(torch.float32)[:, None]
    im_w = im_w.to(torch.float32)[:, None]

    proposals = clip_boxes(bbox_transform_inv(anchors, deltas), im_h[..., None],
                           im_w[..., None])

    min_size = cfg.min_size * im_scale.to(torch.float32)[:, None]
    ws = proposals[..., 2] - proposals[..., 0] + 1.0
    hs = proposals[..., 3] - proposals[..., 1] + 1.0
    size_ok = (ws >= min_size) & (hs >= min_size)

    # padded-canvas guard: grid positions past the valid feature extent see
    # only zero padding
    stride = anchor_cfg.feat_stride
    valid_fh = torch.ceil(im_h / stride).to(torch.int32)[..., None]      # (B, 1, 1)
    valid_fw = torch.ceil(im_w / stride).to(torch.int32)[..., None]
    gy = torch.arange(fh, device=dev)
    gx = torch.arange(fw, device=dev)
    grid_ok = (gy[None, :, None] < valid_fh) & (gx[None, None, :] < valid_fw)
    grid_ok = grid_ok.reshape(b, -1).repeat_interleave(a, dim=1)

    pre_k = min(cfg.pre_nms_topk(train), scores.shape[1])
    top_scores, (px1, py1, px2, py2), top_valid = masked_topk_payload(
        scores, size_ok & grid_ok, pre_k,
        proposals[..., 0], proposals[..., 1], proposals[..., 2], proposals[..., 3])
    top_boxes = torch.stack([px1, py1, px2, py2], dim=-1)

    keep_idx, keep_valid = nms_padded(top_boxes, top_scores, top_valid,
                                      cfg.nms_thresh, cfg.post_nms_topk(train),
                                      presorted=True)
    k = keep_idx.long()
    rois = torch.where(keep_valid[..., None],
                       torch.gather(top_boxes, 1, k[..., None].expand(-1, -1, 4)), 0.0)
    roi_scores = torch.where(keep_valid, torch.gather(top_scores, 1, k), 0.0)
    return Proposals(rois=rois, scores=roi_scores, valid=keep_valid)
