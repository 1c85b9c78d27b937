"""Operations and bytes of the model and of single kernels, from the
configuration's shapes alone.

Nothing here looks at what the program launches, so a count is the same
work whatever implements it.  Model counts are the multiply-adds of the
convolutions and dense layers (the elementwise layers, the pools, the
proposal layer and the epilogue are left out), two operations each.  A
training step counts each trainable layer's forward, its weight gradient
and, where its input takes a gradient, its input gradient; frozen layers
count forward only.  A kernel's bound is the larger of its operations at
the peak rate of their type and its bytes (inputs read once, the output
written once) at the HBM rate, as ``chip_smoke.bound`` takes it.

``Shapes`` holds what the counts need: backbone, batch, canvas, RoIs per
image at test and in training, classes, fc6/fc7 width, RPN width, the pool
size of the configuration's RoI mode, the trunk's feature channels and the
anchors per position.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
BF16_BYTES = 2


class Shapes(NamedTuple):
    backbone: str
    batch: int
    height: int
    width: int
    test_rois: int
    train_rois: int
    num_classes: int
    head_hidden: int
    rpn_channels: int
    pool: int
    feat_channels: int
    anchors: int
    stride: int = 16


class Layer(NamedTuple):
    """A convolution or dense layer of one image (or one RoI): its
    multiply-adds, whether it trains, whether its input takes a gradient,
    and whether it runs once per RoI."""
    name: str
    macs: float
    trains: bool
    input_grad: bool
    per_roi: bool = False


def _conv(name, h, w, cin, cout, k, trains=True, input_grad=True, per_roi=False) -> Layer:
    return Layer(name, float(h * w * cin * cout * k * k), trains, input_grad, per_roi)


def vgg16_layers(s: Shapes) -> List[Layer]:
    """13 3x3 convolutions (a 2x2 pool after blocks 1-4), conv1_1-conv2_2
    frozen and conv3_1's input gradient-free; the RPN; fc6, fc7, cls_score
    and bbox_pred per RoI."""
    blocks = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
    out, cin, h, w = [], 3, s.height, s.width
    for bi, (n, ch) in enumerate(blocks):
        for i in range(n):
            trains = bi >= 2
            out.append(_conv(f"conv{bi + 1}_{i + 1}", h, w, cin, ch, 3, trains,
                             trains and not (bi == 2 and i == 0)))
            cin = ch
        if bi < 4:
            h, w = h // 2, w // 2
    out += _rpn(s)
    p = s.pool
    out += [Layer("fc6", float(p * p * s.feat_channels * s.head_hidden), True, True, True),
            Layer("fc7", float(s.head_hidden * s.head_hidden), True, True, True)]
    return out + _outputs(s, s.head_hidden)


def _bottleneck(name, h, w, cin, ch, stride, project, trains, input_grad, per_roi=False):
    ho, wo = h // stride, w // stride
    layers = [_conv(f"{name}.conv1", ho, wo, cin, ch, 1, trains, input_grad, per_roi),
              _conv(f"{name}.conv2", ho, wo, ch, ch, 3, trains, trains, per_roi),
              _conv(f"{name}.conv3", ho, wo, ch, 4 * ch, 1, trains, trains, per_roi)]
    if project:
        layers.append(_conv(f"{name}.proj", ho, wo, cin, 4 * ch, 1, trains, input_grad,
                            per_roi))
    return layers, ho, wo


def _stage(name, h, w, cin, blocks, ch, stride, trains, input_grad, per_roi=False):
    out = []
    for i in range(blocks):
        layers, h, w = _bottleneck(f"{name}.block{i + 1}", h, w, cin if i == 0 else 4 * ch, ch,
                                   stride if i == 0 else 1, i == 0, trains,
                                   input_grad if i == 0 else trains, per_roi)
        out += layers
    return out, h, w


def resnet101_c4_layers(s: Shapes) -> List[Layer]:
    """conv1 7x7/2 and res2 frozen; res3 (its first block's input
    gradient-free) and res4 train; the RPN; res5 and the outputs per RoI on
    the (2P x 2P) crop."""
    h, w = s.height // 2, s.width // 2
    out = [Layer("conv1", float(h * w * 3 * 64 * 49), False, False)]
    h, w = h // 2, w // 2                                  # 3x3/2 max pool
    layers, h, w = _stage("res2", h, w, 64, 3, 64, 1, False, False)
    out += layers
    layers, h, w = _stage("res3", h, w, 256, 4, 128, 2, True, False)
    out += layers
    layers, h, w = _stage("res4", h, w, 512, 23, 256, 2, True, True)
    out += layers
    out += _rpn(s)
    layers, _, _ = _stage("res5", s.pool, s.pool, s.feat_channels, 3, 512, 2, True, True,
                          per_roi=True)
    return out + layers + _outputs(s, 2048)


def _rpn(s: Shapes) -> List[Layer]:
    h, w = s.height // s.stride, s.width // s.stride
    return [_conv("rpn_conv", h, w, s.feat_channels, s.rpn_channels, 3),
            _conv("rpn_cls_score", h, w, s.rpn_channels, 2 * s.anchors, 1),
            _conv("rpn_bbox_pred", h, w, s.rpn_channels, 4 * s.anchors, 1)]


def _outputs(s: Shapes, hidden: int) -> List[Layer]:
    return [Layer("cls_score", float(hidden * s.num_classes), True, True, True),
            Layer("bbox_pred", float(hidden * 4 * s.num_classes), True, True, True)]


def layers(s: Shapes) -> List[Layer]:
    return vgg16_layers(s) if s.backbone == "vgg16" else resnet101_c4_layers(s)


def detect_flops(s: Shapes) -> float:
    """Operations of one detect call of ``s.batch`` images."""
    return 2.0 * s.batch * sum(l.macs * (s.test_rois if l.per_roi else 1) for l in layers(s))


def train_flops(s: Shapes) -> float:
    """Operations of one training step of ``s.batch`` images: forward,
    weight gradients of trainable layers, input gradients where the input
    takes one."""
    total = 0.0
    for l in layers(s):
        n = s.train_rois if l.per_roi else 1
        total += l.macs * n * (1 + int(l.trains) + int(l.input_grad))
    return 2.0 * s.batch * total


def bound_ms(nbytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time in ms and what bounds it: bytes at the HBM rate or
    operations at ``ops_per_s``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stem_bound(s: Shapes) -> Dict[str, float]:
    """K3 (conv1_1 + ReLU + conv1_2 + ReLU + 2x2 pool, bf16) on the batch's
    canvases: 2 (27 + 576) 64 operations a pixel on the tensor cores; reads
    the bf16 canvas and the weights, writes the pooled (H/2, W/2, 64) map."""
    pixels = s.batch * s.height * s.width
    ops = 2.0 * pixels * 64 * (27 + 576)
    nbytes = (pixels * 3 + pixels // 4 * 64 + 64 * 27 + 64 * 576) * BF16_BYTES + 2 * 64 * 4
    ms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
    return {"ops": ops, "bytes": float(nbytes), "bound_ms": ms, "bound_by": by}


def _align(s: Shapes, rois: int, sampling: int = 2):
    bins = s.batch * rois * s.pool * s.pool
    # per sample, channel and corner a product of two weights and an add,
    # per bin the mean
    ops = bins * s.feat_channels * (3.0 * 4 * sampling * sampling + 1)
    feat = s.batch * (s.height // s.stride) * (s.width // s.stride) * s.feat_channels * BF16_BYTES
    return bins, ops, feat, s.batch * rois * 4 * 4


def roi_align_bound(s: Shapes) -> Dict[str, float]:
    """K5 on the detect call's RoIs: reads the bf16 map and the RoIs, writes
    bf16 crops; its arithmetic is float32 on the CUDA cores."""
    bins, ops, feat, rois = _align(s, s.test_rois)
    nbytes = feat + rois + bins * s.feat_channels * BF16_BYTES
    ms, by = bound_ms(nbytes, ops, F32_OPS_PER_S)
    return {"ops": ops, "bytes": float(nbytes), "bound_ms": ms, "bound_by": by}


def roi_align_bwd_bound(s: Shapes) -> Dict[str, float]:
    """K6 on the training step's sampled RoIs: reads the RoIs and the bf16
    crop gradient, writes the bf16 map gradient."""
    bins, ops, feat, rois = _align(s, s.train_rois)
    nbytes = rois + bins * s.feat_channels * BF16_BYTES + feat
    ms, by = bound_ms(nbytes, ops, F32_OPS_PER_S)
    return {"ops": ops, "bytes": float(nbytes), "bound_ms": ms, "bound_by": by}
