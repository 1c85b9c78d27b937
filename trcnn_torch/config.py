"""Configuration tree: the port's own copy of ``trcnn/config.py``.

One frozen-dataclass hierarchy holding every numerical constant of the
Faster R-CNN contract, with the field names and defaults of the JAX
package's classes, so ``dataclasses.asdict`` of either tree is the same
dict.  The port reads configs by attribute only, so an instance of the JAX
package's classes works wherever one of these is expected.  The port keeps
a copy rather than importing ``trcnn.config``: it imports nothing of the
JAX package.  All defaults are the published Faster R-CNN / py-faster-rcnn
VGG-16 VOC configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

VOC_CLASSES: Tuple[str, ...] = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

# COCO-2017: 80 foreground classes + background
NUM_COCO_CLASSES = 81


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor generation: base 16, 3 ratios x 3 scales, A = 9."""

    base_size: int = 16
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    scales: Tuple[float, ...] = (8.0, 16.0, 32.0)
    feat_stride: int = 16

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """Proposal layer capacities (static top-k / post-NMS sizes) and
    thresholds.  ``nms_impl`` selects the JAX package's NMS formulation;
    the port always runs kernel K1 on the card."""

    pre_nms_topk_train: int = 12000
    post_nms_topk_train: int = 2000
    pre_nms_topk_test: int = 6000
    post_nms_topk_test: int = 300
    nms_thresh: float = 0.7
    min_size: float = 16.0  # scaled by im_scale at call time
    nms_impl: str = "auto"

    def pre_nms_topk(self, train: bool) -> int:
        return self.pre_nms_topk_train if train else self.pre_nms_topk_test

    def post_nms_topk(self, train: bool) -> int:
        return self.post_nms_topk_train if train else self.post_nms_topk_test


@dataclasses.dataclass(frozen=True)
class AnchorTargetConfig:
    """RPN training target assignment."""

    allowed_border: float = 0.0
    positive_iou: float = 0.7
    negative_iou: float = 0.3
    batch_size: int = 256       # sampled anchors per image
    fg_fraction: float = 0.5
    clobber_positives: bool = False


@dataclasses.dataclass(frozen=True)
class ProposalTargetConfig:
    """RoI head training target assignment."""

    rois_per_image: int = 128
    fg_fraction: float = 0.25
    fg_iou: float = 0.5
    bg_iou_hi: float = 0.5
    bg_iou_lo: float = 0.1
    bbox_normalize_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)


@dataclasses.dataclass(frozen=True)
class RoIConfig:
    """RoI feature extraction: "max" is Caffe's roi_pooling_2d, "align"
    bilinear RoIAlign (not ported yet)."""

    output_size: int = 7
    spatial_scale: float = 1.0 / 16.0
    mode: str = "max"


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    """Preprocessing: BGR, Caffe pixel means, 600/1000 scaling onto a static
    ``pad_h`` x ``pad_w`` canvas (a multiple of the feature stride)."""

    target_min_size: int = 600
    target_max_size: int = 1000
    pixel_means_bgr: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    pad_h: int = 608
    pad_w: int = 1024
    # multi-scale training: per-image random shorter-side target; () disables
    multiscale_min_sizes: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Smooth-L1 sigmas of the RPN and head box losses."""

    rpn_smooth_l1_sigma: float = 3.0
    head_smooth_l1_sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """MomentumSGD schedule, Caffe order (``trcnn_torch/train/optim.py``)."""

    base_lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay_factor: float = 0.1
    lr_decay_step: int = 50000
    total_iters: int = 70000
    # linear lr warmup from base_lr * warmup_factor over warmup_steps; 0 off
    warmup_steps: int = 0
    warmup_factor: float = 1.0 / 3.0
    # global-norm gradient clipping before every other transform; 0.0 off
    clip_grad_norm: float = 0.0


@dataclasses.dataclass(frozen=True)
class TestTimeConfig:
    """Test-time post-processing.  ``nms_impl`` selects the JAX package's
    epilogue NMS; the port runs kernel K1."""

    nms_thresh: float = 0.3
    score_thresh_eval: float = 0.05
    score_thresh_demo: float = 0.7
    max_dets_per_class: int = 100
    max_dets_per_image: int = 100
    nms_impl: str = "xla"


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    """Top-level config."""

    num_classes: int = len(VOC_CLASSES)
    backbone: str = "vgg16"  # or "resnet101" (not ported yet)
    head_hidden: int = 4096  # fc6/fc7 width; small in unit tests
    rpn_channels: int = 512  # RPN 3x3 conv width
    head_dropout: float = 0.5  # fc6/fc7 dropout rate; 0.0 disables
    anchors: AnchorConfig = AnchorConfig()
    proposals: ProposalConfig = ProposalConfig()
    anchor_targets: AnchorTargetConfig = AnchorTargetConfig()
    proposal_targets: ProposalTargetConfig = ProposalTargetConfig()
    roi: RoIConfig = RoIConfig()
    image: ImageConfig = ImageConfig()
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    test: TestTimeConfig = TestTimeConfig()

    def replace(self, **kw) -> "FasterRCNNConfig":
        return dataclasses.replace(self, **kw)


def voc_config() -> FasterRCNNConfig:
    """Default VOC 21-class configuration."""
    return FasterRCNNConfig()


def coco_config() -> FasterRCNNConfig:
    """COCO-2017 configuration: 81 classes, larger test capacity, the
    800 x 1344 canvas and multi-scale training."""
    return FasterRCNNConfig(
        num_classes=NUM_COCO_CLASSES,
        proposals=ProposalConfig(
            pre_nms_topk_train=12000,
            post_nms_topk_train=2000,
            pre_nms_topk_test=6000,
            post_nms_topk_test=1000,
        ),
        image=ImageConfig(target_min_size=800, target_max_size=1333,
                          pad_h=800, pad_w=1344,
                          multiscale_min_sizes=(640, 672, 704, 736, 768, 800)),
        test=TestTimeConfig(max_dets_per_class=100, max_dets_per_image=100),
    )
