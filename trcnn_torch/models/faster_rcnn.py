"""Faster R-CNN (port of ``trcnn/models/faster_rcnn.py``).

``FasterRCNN.detect`` runs the inference path: uint8 canvas preparation,
VGG-16 trunk, RPN, the batched proposal layer, RoI max-pool and the fc head.
``postprocess`` is the test-time epilogue: de-normalise and decode the
class-specific deltas, clip, grouped per-class NMS, and map back to
original-image coordinates.  ``FasterRCNN.losses`` is the training forward:
anchor targets, the RPN losses, proposals (train capacities) on the
detached RPN outputs, proposal targets and the head losses.  Given a
data-parallel group, each rank's losses are its shares of the global
batch's (normalised by the global batch and its global valid-slot count,
drawn from the global batch's draws), so that the ranks' gradients sum to
the gradient one process computes on the whole batch.

``cfg.backbone`` picks the trunk and the RoI head, as
``trcnn/models/faster_rcnn.py:88-104`` does: "vgg16" (VGG-16 trunk, 7x7
RoI pool, fc6/fc7 head) or "resnet101" (ResNet-101-C4 trunk, 14x14 RoI
pool, res5 head).  ``cfg.roi.mode`` picks the pooling: "max" (Caffe's RoI
max pool) or "align" (RoIAlign, 2 x 2 samples per bin, float32 output),
at the same pool size.  ``quant="int8"`` runs VGG-16's convolutions from
conv2_1 and fc6/fc7 as dynamic int8 products (``ops/quant.py``), for
inference only.

Each stage runs inside a ``profiling.span`` (``frcnn.prepare``,
``frcnn.trunk``, ``frcnn.rpn``, ``frcnn.proposals``, ``frcnn.pool``,
``frcnn.head``; ``postprocess`` is ``frcnn.postprocess``, and the training
forward adds ``frcnn.targets``).  Under a profiler every device operation
of ``detect`` and ``postprocess`` is launched inside exactly one of them;
with none they cost one flag read each.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from trcnn_torch import parallel
from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.models.losses import masked_mean, smooth_l1, softmax_ce
from trcnn_torch.models.resnet import Bottleneck, FrozenBatchNorm, ResNet101C4, ResNetC5Head
from trcnn_torch.models.roi_head import VGG16RoIHead
from trcnn_torch.models.rpn import RPNHead
from trcnn_torch.models.vgg16 import VGG16
from trcnn_torch.ops.anchors import shifted_anchors
from trcnn_torch.ops.boxes import bbox_transform_inv, clip_boxes, device_constant
from trcnn_torch.ops.nms import multiclass_nms
from trcnn_torch.ops.proposal import proposal_layer
from trcnn_torch.ops.roi_align import roi_align
from trcnn_torch.ops.roi_pool import roi_max_pool
from trcnn_torch.targets import anchor_targets, proposal_targets
from trcnn_torch.utils.profiling import span

# the uniform draws of the sampling layers: anchor targets over the anchors,
# proposal targets over the candidates (proposals, then gt)
UNIFORM_KEYS = ("at_fg", "at_bg", "pt_fg", "pt_bg")


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
    """Trunk + RPN + RoI head.  ``dtype`` is the compute dtype; the
    parameters, the RPN outputs and the cls_score/bbox_pred layers stay
    float32.  ``quant``: "none", or "int8" (VGG-16 only, inference only;
    the parameters are the float model's)."""

    def __init__(self, cfg: FasterRCNNConfig = FasterRCNNConfig(),
                 dtype: torch.dtype = torch.float32, device="cuda", quant: str = "none"):
        super().__init__()
        if cfg.roi.mode not in ("max", "align"):
            raise ValueError(f"unknown RoI mode {cfg.roi.mode!r}")
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        if quant != "none" and cfg.backbone != "vgg16":
            raise ValueError("quant='int8' currently supports the vgg16 backbone only")
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant
        p = cfg.roi.output_size
        if cfg.backbone == "vgg16":
            extractor, feat_channels, self.pool_size = VGG16(dtype, device, quant), 512, p
            head = VGG16RoIHead(p * p * 512, cfg.num_classes, cfg.head_hidden, dtype, device,
                                dropout_rate=cfg.head_dropout, quant=quant)
        elif cfg.backbone == "resnet101":
            extractor, feat_channels, self.pool_size = ResNet101C4(dtype, device), 1024, 2 * p
            head = ResNetC5Head(cfg.num_classes, dtype, device)
        else:
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        self.extractor = extractor
        self.rpn = RPNHead(feat_channels, cfg.anchors.num_anchors, cfg.rpn_channels, dtype,
                           device)
        self.head = head
        self.register_buffer("pixel_means", torch.tensor(
            cfg.image.pixel_means_bgr, dtype=torch.float32, device=device),
            persistent=False)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "FasterRCNN":
        """Seeded init mirroring flax's: lecun_normal (truncated normal,
        fan-in scaled) conv and dense weights, zero biases, normal(0.01) for
        the RPN convs and cls_score, normal(0.001) for bbox_pred; for
        ResNet-101, zero bottleneck conv3 kernels and identity FrozenBNs
        (scale 1, bias 0, mean 0, var 1)."""
        gaussian = {self.rpn.rpn_conv: 0.01, self.rpn.rpn_cls_score: 0.01,
                    self.rpn.rpn_bbox_pred: 0.01, self.head.cls_score: 0.01,
                    self.head.bbox_pred: 0.001}
        zero = {m.conv3 for m in self.modules() if isinstance(m, Bottleneck)}
        for m in self.modules():
            if isinstance(m, FrozenBatchNorm):
                m.reset_parameters()
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            if m in gaussian:
                m.weight.normal_(0.0, gaussian[m], generator=generator)
            elif m in zero:
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                # flax's truncated_normal(-2, 2) rescaled to unit variance
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            if m.bias is not None:
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

    def _features(self, images: torch.Tensor, im_info: torch.Tensor) -> torch.Tensor:
        """The trunk's features of the prepared canvas, which is freed on
        return, as soon as the trunk is done with it."""
        with span("frcnn.prepare"):
            x = self._prepare(images, im_info)
        with span("frcnn.trunk"):
            return self.extractor(x)

    def roi_forward(self, feat: torch.Tensor, rois: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    shard: Tuple[int, int] = (0, 1)):
        """feat (B, fH, fW, C), rois (B, R, 4) -> (cls_score (B, R, K),
        bbox_pred (B, R, 4K)); all images' crops, pooled at ``pool_size``
        (RoI max pool, or RoIAlign with 2 x 2 samples per bin as
        ``trcnn/models/faster_rcnn.py:145-149`` calls it), go through the
        head as one (B*R) batch, in the layout the pool writes.
        ``generator`` draws the VGG head's dropout masks (training); None
        runs the deterministic head.  ``shard`` (i, n): this rank's slot
        among n data-parallel ranks, whose masks are rows of the global
        batch's (:meth:`draw_uniforms`)."""
        with span("frcnn.pool"):
            pooled = self._pool(feat, rois)
        with span("frcnn.head"):
            return self._head(pooled, generator, shard)

    def _pool(self, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        if self.cfg.roi.mode == "align":
            # the crops in the head's compute dtype: bit-equal to JAX's
            # float32 crops cast by the head, with no float32 crop tensor
            return roi_align(feat, rois.contiguous(), self.pool_size,
                             self.cfg.roi.spatial_scale, out_dtype=self.dtype)
        return roi_max_pool(feat, rois.contiguous(), self.pool_size,
                            self.cfg.roi.spatial_scale)

    def _head(self, pooled: torch.Tensor, generator: Optional[torch.Generator] = None,
              shard: Tuple[int, int] = (0, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled (B, R, ...) -> (cls_score (B, R, K), bbox_pred (B, R, 4K))."""
        b, r = pooled.shape[:2]
        cls_score, bbox_pred = self.head(pooled.reshape((b * r,) + pooled.shape[2:]),
                                         generator, shard)
        return cls_score.reshape(b, r, -1), bbox_pred.reshape(b, r, -1)

    def detect(self, images: torch.Tensor, im_info: torch.Tensor) -> RawDetections:
        """images (B, H, W, 3): mean-subtracted BGR float or raw uint8 canvas;
        im_info (B, 3) float32 rows (scaled_h, scaled_w, im_scale)."""
        feat = self._features(images, im_info)
        with span("frcnn.rpn"):
            rpnout = self.rpn(feat)
        with span("frcnn.proposals"):
            rois, roi_valid = self.propose(rpnout, im_info, train=False)
        del rpnout                  # not held through the head's peak
        with span("frcnn.pool"):
            pooled = self._pool(feat, rois)
        with span("frcnn.head"):
            cls_score, bbox_pred = self._head(pooled)
            cls_prob = torch.softmax(cls_score, dim=-1)
        return RawDetections(rois=rois, roi_valid=roi_valid, cls_prob=cls_prob,
                             bbox_pred=bbox_pred)

    def propose(self, rpnout, im_info: torch.Tensor, train: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The proposal layer for the batch on the detached RPN outputs (no
        gradient through the proposals' coordinates) -> rois (B, P, 4),
        valid (B, P); ``train`` picks the training capacities."""
        props = proposal_layer(rpnout.fg_probs.detach(), rpnout.deltas.detach(),
                               im_info[:, 0], im_info[:, 1], im_info[:, 2], train=train,
                               anchor_cfg=self.cfg.anchors, cfg=self.cfg.proposals)
        return props.rois, props.valid

    def draw_uniforms(self, b: int, feat_hw: Tuple[int, int], num_gt: int,
                      generator: torch.Generator, shard: Tuple[int, int] = (0, 1)
                      ) -> Dict[str, torch.Tensor]:
        """The sampling layers' uniforms for a batch of ``b`` images: at_fg
        and at_bg (B, fH*fW*A) over the anchors, pt_fg and pt_bg
        (B, post_nms_topk_train + G) over the proposal candidates, drawn in
        that order from ``generator`` on its device.  ``shard`` (i, n): the
        draws are the global batch's (n * b rows), of which rank i keeps
        rows i*b to (i+1)*b, so that n ranks sample what one process does."""
        i, ranks = shard
        n = feat_hw[0] * feat_hw[1] * self.cfg.anchors.num_anchors
        n_cand = self.cfg.proposals.post_nms_topk_train + num_gt
        dev = generator.device
        return {k: torch.rand((ranks * b, n if k.startswith("at") else n_cand),
                              generator=generator, device=dev)[i * b:(i + 1) * b]
                for k in UNIFORM_KEYS}

    def losses(self, images: torch.Tensor, im_info: torch.Tensor, gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor, generator: torch.Generator,
               uniforms: Optional[Dict[str, torch.Tensor]] = None,
               proposals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               group=None) -> Dict[str, torch.Tensor]:
        """Training forward: the four losses of approximate joint training.

        images (B, H, W, 3) canvas (uint8 or mean-subtracted float), im_info
        (B, 3); gt_boxes (B, G, 4) in canvas coordinates, gt_labels (B, G),
        gt_valid (B, G) bool.  ``generator`` (on the images' device) draws
        the sampling uniforms (:meth:`draw_uniforms`), then the dropout
        masks.  ``uniforms`` hands in the four draws instead (the tests feed
        the JAX package's).  ``proposals`` (rois (B, P, 4), valid (B, P))
        replaces the proposal layer's output, so that two devices can be
        compared on one proposal set.  ``uniforms`` and ``proposals`` hold
        this process's images only.

        ``group``: a data-parallel process group (None: one process).  The
        batch is then this rank's shard of a global batch of equal shards,
        and each value returned is this rank's share of the global batch's:
        the per-image means divide by the global image count, ``cls_loss``
        by the valid slots counted over the group (an image with no
        candidate has none), and the draws are rows of the global batch's.
        Summed over the ranks, the values and their gradients are what one
        process computes on the whole batch, as under the JAX package's
        mesh.  Over a (data, model) grid ``group`` is the data group: the
        model ranks of one data index draw the same uniforms and masks and
        count over their data group only (summed over the world, each count
        would come ``n_model`` times).

        Returns the seven-key dict of the JAX package: loss, rpn_cls_loss,
        rpn_bbox_loss, cls_loss, bbox_loss (float32 scalars with autograd)
        and num_fg_anchors, num_fg_rois (per-image means).
        """
        if self.quant != "none":
            raise ValueError("quantized models are inference-only: round passes no "
                             "gradient (train fp32, deploy int8)")
        cfg = self.cfg
        b = images.shape[0]
        shard = parallel.shard_of(group)
        b_global = b * shard[1]
        feat = self._features(images, im_info)
        with span("frcnn.rpn"):
            rpnout = self.rpn(feat)
        _, fh, fw, _ = feat.shape
        a = cfg.anchors.num_anchors
        n = fh * fw * a

        # ---- proposals (no gradient through their coordinates), then the
        # sampling of anchors and proposals
        if proposals is None:
            with span("frcnn.proposals"):
                proposals = self.propose(rpnout, im_info, train=True)
        with span("frcnn.targets"):
            if uniforms is None:
                uniforms = self.draw_uniforms(b, (fh, fw), gt_boxes.shape[1], generator, shard)
            anchors = shifted_anchors(fh, fw, cfg.anchors, device=feat.device)
            at = anchor_targets(anchors, gt_boxes, gt_valid, im_info[:, 0], im_info[:, 1],
                                uniforms["at_fg"], uniforms["at_bg"], cfg.anchor_targets)
            pt = proposal_targets(proposals[0], proposals[1], gt_boxes, gt_labels, gt_valid,
                                  uniforms["pt_fg"], uniforms["pt_bg"], cfg.proposal_targets)

        # ---- RPN losses, normalised per image by the sampled-anchor count
        # (B, fH, fW, 2, A) -> (B, N, 2) in anchor order (position major)
        logits = rpnout.logits.reshape(b, fh * fw, 2, a).transpose(2, 3).reshape(b, n, 2)
        deltas = rpnout.deltas.reshape(b, n, 4)
        denom = at.num_examples.float().clamp(min=1.0)
        ce = softmax_ce(logits, at.labels.clamp(min=0))
        rpn_cls_loss = (torch.where(at.labels >= 0, ce, 0.0).sum(1) / denom).sum() / b_global
        l1 = smooth_l1(deltas - at.bbox_targets, cfg.loss.rpn_smooth_l1_sigma).sum(-1)
        rpn_bbox_loss = (torch.where(at.labels == 1, l1, 0.0).sum(1) / denom).sum() / b_global

        # ---- head losses
        cls_score, bbox_pred = self.roi_forward(feat, pt.rois, generator, shard)
        s = pt.labels.shape[1]
        num_valid = pt.valid.sum().float()
        parallel.all_reduce_sum_([num_valid], group)
        cls_loss = masked_mean(softmax_ce(cls_score, pt.labels), pt.valid, denom=num_valid)
        pred = bbox_pred.reshape(b, s, cfg.num_classes, 4)
        pred = torch.gather(pred, 2, pt.labels.long()[..., None, None].expand(b, s, 1, 4))
        head_l1 = smooth_l1(pred[:, :, 0] - pt.bbox_targets,
                            cfg.loss.head_smooth_l1_sigma).sum(-1)
        # Caffe's SmoothL1Loss normalises by the RoI blob size (B*S)
        bbox_loss = masked_mean(head_l1, pt.is_fg, denom=b_global * s)

        return {
            "loss": rpn_cls_loss + rpn_bbox_loss + cls_loss + bbox_loss,
            "rpn_cls_loss": rpn_cls_loss,
            "rpn_bbox_loss": rpn_bbox_loss,
            "cls_loss": cls_loss,
            "bbox_loss": bbox_loss,
            "num_fg_anchors": at.num_fg.float().sum() / b_global,
            "num_fg_rois": pt.num_fg.float().sum() / b_global,
        }

    forward = detect


def postprocess(raw: RawDetections, im_info: torch.Tensor, cfg: FasterRCNNConfig,
                score_thresh: Optional[float] = None) -> Detections:
    """Decode, clip, grouped per-class NMS and merge for the batch (one NMS
    launch); boxes are divided by im_scale into original-image coordinates."""
    with span("frcnn.postprocess"):
        t = cfg.test
        if score_thresh is None:
            score_thresh = t.score_thresh_eval
        dev = raw.rois.device
        b, r = raw.rois.shape[:2]
        k = cfg.num_classes
        stds = device_constant(tuple(cfg.proposal_targets.bbox_normalize_stds) * k, dev)
        means = device_constant(tuple(cfg.proposal_targets.bbox_normalize_means) * k, dev)
        deltas = raw.bbox_pred * stds + means
        info = im_info[:, None, None, :]                          # (B, 1, 1, 3)
        boxes = clip_boxes(bbox_transform_inv(raw.rois, deltas), info[..., 0], info[..., 1])
        boxes = boxes.reshape(b, r, k, 4)
        det_boxes, det_scores, det_classes, det_valid = multiclass_nms(
            boxes, raw.cls_prob, raw.roi_valid, t.nms_thresh, score_thresh,
            max_per_class=t.max_dets_per_class, max_total=t.max_dets_per_image)
        return Detections(det_boxes / im_info[:, None, None, 2], det_scores, det_classes,
                          det_valid)


def make_model(cfg: FasterRCNNConfig = FasterRCNNConfig(),
               dtype: torch.dtype = torch.float32, device="cuda",
               quant: str = "none") -> FasterRCNN:
    """The model with float32 parameters on ``device``: the card unless the
    caller asks for the CPU.  Without a card, the default raises.
    ``quant="int8"``: dynamic int8 inference (VGG-16 only)."""
    return FasterRCNN(cfg, dtype, device, quant)


_F32_ISLANDS = ("cls_score", "bbox_pred")


@torch.no_grad()
def cast_params_for_inference(model: FasterRCNN, dtype: torch.dtype) -> FasterRCNN:
    """One-time weight cast to the compute dtype for serving, in place.

    Every layer casts its weight to the compute dtype at use, so the cast
    leaves the activations bit-identical while removing a per-call cast.
    Biases stay float32, and so do the float32 islands cls_score and
    bbox_pred and ResNet-101's FrozenBN leaves (their fold runs in float32
    before it is cast).  Training must not use this.
    """
    if dtype == torch.float32:
        return model
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and name.rsplit(".", 1)[-1] not in _F32_ISLANDS:
            m.weight.data = m.weight.data.to(dtype)
    return model
