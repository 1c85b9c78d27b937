"""Faster R-CNN detect graph (port of ``trcnn/models/faster_rcnn.py``).

``FasterRCNN.detect`` runs the inference path: uint8 canvas preparation,
VGG-16 trunk, RPN, per-image proposal layer, RoI max-pool and the fc head.
``postprocess`` is the test-time epilogue: de-normalise and decode the
class-specific deltas, clip, grouped per-class NMS, and map back to
original-image coordinates.  Only the VGG-16 backbone and max pooling are
ported so far.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.models.roi_head import VGG16RoIHead
from trcnn_torch.models.rpn import RPNHead
from trcnn_torch.models.vgg16 import VGG16
from trcnn_torch.ops.boxes import bbox_transform_inv, clip_boxes
from trcnn_torch.ops.nms import multiclass_nms
from trcnn_torch.ops.proposal import proposal_layer
from trcnn_torch.ops.roi_pool import roi_max_pool


class RawDetections(NamedTuple):
    rois: torch.Tensor        # (B, R, 4) proposal boxes, image coords
    roi_valid: torch.Tensor   # (B, R) bool
    cls_prob: torch.Tensor    # (B, R, C) softmax class probabilities
    bbox_pred: torch.Tensor   # (B, R, 4C) normalised per-class deltas


class Detections(NamedTuple):
    boxes: torch.Tensor       # (B, D, 4) original-image coordinates
    scores: torch.Tensor      # (B, D)
    classes: torch.Tensor     # (B, D) int32
    valid: torch.Tensor       # (B, D) bool


class FasterRCNN(nn.Module):
    """VGG-16 trunk + RPN + RoI head.  ``dtype`` is the compute dtype; the
    RPN outputs and the cls_score/bbox_pred layers stay float32."""

    def __init__(self, cfg: FasterRCNNConfig = FasterRCNNConfig(),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if cfg.backbone != "vgg16":
            raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported yet")
        if cfg.roi.mode != "max":
            raise NotImplementedError(f"RoI mode {cfg.roi.mode!r} is not ported yet")
        self.cfg = cfg
        self.dtype = dtype
        p = cfg.roi.output_size
        self.extractor = VGG16(dtype, device)
        self.rpn = RPNHead(512, cfg.anchors.num_anchors, cfg.rpn_channels, dtype, device)
        self.head = VGG16RoIHead(p * p * 512, cfg.num_classes, cfg.head_hidden,
                                 dtype, device)
        self.register_buffer("pixel_means", torch.tensor(
            cfg.image.pixel_means_bgr, dtype=torch.float32, device=device),
            persistent=False)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "FasterRCNN":
        """Seeded init mirroring flax's: lecun_normal (truncated normal,
        fan-in scaled) conv and dense weights, zero biases, normal(0.01) for
        the RPN convs and cls_score, normal(0.001) for bbox_pred."""
        gaussian = {self.rpn.rpn_conv: 0.01, self.rpn.rpn_cls_score: 0.01,
                    self.rpn.rpn_bbox_pred: 0.01, self.head.cls_score: 0.01,
                    self.head.bbox_pred: 0.001}
        for m in self.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            if m in gaussian:
                m.weight.normal_(0.0, gaussian[m], generator=generator)
            else:
                fan_in = m.weight[0].numel()
                # flax's truncated_normal(-2, 2) rescaled to unit variance
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            m.bias.zero_()
        return self

    def _prepare(self, images: torch.Tensor, im_info: torch.Tensor) -> torch.Tensor:
        """A uint8 canvas becomes float32 minus the BGR means, with the pad
        region (outside im_info's extent) zeroed again; float input passes."""
        if images.dtype != torch.uint8:
            return images
        x = images.float() - self.pixel_means
        _, h, w, _ = images.shape
        yy = torch.arange(h, device=images.device)[None, :, None, None]
        xx = torch.arange(w, device=images.device)[None, None, :, None]
        inside = ((yy < im_info[:, 0, None, None, None])
                  & (xx < im_info[:, 1, None, None, None]))
        return torch.where(inside, x, 0.0)

    def roi_forward(self, feat: torch.Tensor, rois: torch.Tensor):
        """feat (B, fH, fW, C), rois (B, R, 4) -> (cls_score (B, R, K),
        bbox_pred (B, R, 4K)); all images' crops go through the head as one
        (B*R) batch."""
        b, r = rois.shape[:2]
        pooled = roi_max_pool(feat, rois.contiguous(), self.cfg.roi.output_size,
                              self.cfg.roi.spatial_scale)
        cls_score, bbox_pred = self.head(pooled.reshape((b * r,) + pooled.shape[2:]))
        return cls_score.reshape(b, r, -1), bbox_pred.reshape(b, r, -1)

    def detect(self, images: torch.Tensor, im_info: torch.Tensor) -> RawDetections:
        """images (B, H, W, 3): mean-subtracted BGR float or raw uint8 canvas;
        im_info (B, 3) float32 rows (scaled_h, scaled_w, im_scale)."""
        feat = self.extractor(self._prepare(images, im_info))
        rpnout = self.rpn(feat)
        props = [proposal_layer(rpnout.fg_probs[i], rpnout.deltas[i],
                                im_info[i, 0], im_info[i, 1], im_info[i, 2],
                                train=False, anchor_cfg=self.cfg.anchors,
                                cfg=self.cfg.proposals)
                 for i in range(images.shape[0])]
        rois = torch.stack([p.rois for p in props])
        cls_score, bbox_pred = self.roi_forward(feat, rois)
        return RawDetections(rois=rois,
                             roi_valid=torch.stack([p.valid for p in props]),
                             cls_prob=torch.softmax(cls_score, dim=-1),
                             bbox_pred=bbox_pred)

    forward = detect


def postprocess(raw: RawDetections, im_info: torch.Tensor, cfg: FasterRCNNConfig,
                score_thresh: Optional[float] = None) -> Detections:
    """Decode, clip, grouped per-class NMS and merge, per image; boxes are
    divided by im_scale into original-image coordinates."""
    t = cfg.test
    if score_thresh is None:
        score_thresh = t.score_thresh_eval
    dev = raw.rois.device
    k = cfg.num_classes
    stds = _device_constant(cfg.proposal_targets.bbox_normalize_stds * k, dev)
    means = _device_constant(cfg.proposal_targets.bbox_normalize_means * k, dev)
    outs = []
    for i in range(raw.rois.shape[0]):
        info = im_info[i]
        deltas = raw.bbox_pred[i] * stds + means
        boxes = clip_boxes(bbox_transform_inv(raw.rois[i], deltas), info[0], info[1])
        boxes = boxes.reshape(boxes.shape[0], k, 4)
        det_boxes, det_scores, det_classes, det_valid = multiclass_nms(
            boxes, raw.cls_prob[i], raw.roi_valid[i], t.nms_thresh, score_thresh,
            max_per_class=t.max_dets_per_class, max_total=t.max_dets_per_image)
        outs.append((det_boxes / info[2], det_scores, det_classes, det_valid))
    return Detections(*(torch.stack(x) for x in zip(*outs)))


@lru_cache(maxsize=16)
def _device_constant(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, made once and shared read-only: a
    copy from pageable host memory synchronises the stream."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def make_model(cfg: FasterRCNNConfig = FasterRCNNConfig(),
               dtype: torch.dtype = torch.float32, device=None) -> FasterRCNN:
    return FasterRCNN(cfg, dtype, device)


_F32_ISLANDS = ("cls_score", "bbox_pred")


@torch.no_grad()
def cast_params_for_inference(model: FasterRCNN, dtype: torch.dtype) -> FasterRCNN:
    """One-time weight cast to the compute dtype for serving, in place.

    Every layer casts its weight to the compute dtype at use, so the cast
    leaves the activations bit-identical while removing a per-call cast.
    Biases stay float32, and so do the float32 islands cls_score and
    bbox_pred.  Training must not use this.
    """
    if dtype == torch.float32:
        return model
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and name.rsplit(".", 1)[-1] not in _F32_ISLANDS:
            m.weight.data = m.weight.data.to(dtype)
    return model
