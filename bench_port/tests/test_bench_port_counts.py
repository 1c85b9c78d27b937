"""bench_port.counts against hand derivations."""

import math

import pytest

from bench_port import counts as c

VOC = c.Shapes("vgg16", 8, 608, 1024, 300, 128, 21, 4096, 512, 7, 512, 9)
# Detectron's C4 RPN: as wide as the trunk, 5 sizes x 3 ratios
COCO_R101 = c.Shapes("resnet101", 8, 800, 1344, 1000, 128, 81, 4096, 1024, 14, 1024, 15)


def test_vgg16_convolutions_at_224_are_15_35_gmac():
    s = VOC._replace(batch=1, height=224, width=224)
    convs = [l for l in c.vgg16_layers(s) if l.name.startswith("conv")]
    assert len(convs) == 13
    # 224^2 (3*64 + 64*64) + 112^2 (64*128 + 128^2) + 56^2 (128*256 + 2*256^2)
    # + 28^2 (256*512 + 2*512^2) + 14^2 (3*512^2), 9 taps each
    hand = 9 * (224 ** 2 * (3 * 64 + 64 * 64) + 112 ** 2 * (64 * 128 + 128 * 128)
                + 56 ** 2 * (128 * 256 + 2 * 256 * 256) + 28 ** 2 * (256 * 512 + 2 * 512 * 512)
                + 14 ** 2 * 3 * 512 * 512)
    assert sum(l.macs for l in convs) == hand
    assert round(hand / 1e9, 2) == 15.35


def test_vgg16_voc_detect_call():
    rpn = 38 * 64 * (512 * 512 * 9 + 512 * 18 + 512 * 36)
    head = 7 * 7 * 512 * 4096 + 4096 * 4096 + 4096 * 21 + 4096 * 84
    convs = 15346630656 * (608 * 1024) / (224 * 224)
    assert c.detect_flops(VOC) == pytest.approx(2 * 8 * (convs + rpn + 300 * head), rel=1e-12)
    assert c.detect_flops(VOC) / 1e12 == pytest.approx(3.7155, abs=1e-4)


def test_vgg16_training_counts_frozen_layers_forward_only():
    s = VOC._replace(batch=1)
    layers = {l.name: l for l in c.vgg16_layers(s)}
    frozen = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")
    total = 0.0
    for name, l in layers.items():
        n = 128 if l.per_roi else 1
        passes = 1 if name in frozen else (2 if name == "conv3_1" else 3)
        total += l.macs * n * passes
    assert c.train_flops(s) == pytest.approx(2 * total, rel=1e-12)


def bottleneck(h, w, cin, ch, project):
    macs = h * w * (cin * ch + 9 * ch * ch + ch * 4 * ch)
    return macs + (h * w * cin * 4 * ch if project else 0)


def test_resnet101_c4_trunk_and_res5_per_roi():
    s = COCO_R101._replace(batch=1)
    h, w = 200, 336
    trunk = 400 * 672 * 3 * 64 * 49
    trunk += bottleneck(h, w, 64, 64, True) + 2 * bottleneck(h, w, 256, 64, False)
    trunk += bottleneck(100, 168, 256, 128, True) + 3 * bottleneck(100, 168, 512, 128, False)
    trunk += bottleneck(50, 84, 512, 256, True) + 22 * bottleneck(50, 84, 1024, 256, False)
    res5 = bottleneck(7, 7, 1024, 512, True) + 2 * bottleneck(7, 7, 2048, 512, False)
    layers = c.resnet101_c4_layers(s)
    assert sum(l.macs for l in layers if not l.per_roi and not l.name.startswith("rpn")) == trunk
    assert sum(l.macs for l in layers if l.name.startswith("res5")) == res5
    assert round(res5 / 1e9, 3) == 0.732
    rpn = 50 * 84 * (1024 * 1024 * 9 + 1024 * 30 + 1024 * 60)
    assert sum(l.macs for l in layers if l.name.startswith("rpn")) == rpn
    assert c.detect_flops(COCO_R101) == pytest.approx(2 * 8 * (trunk + rpn + 1000 * (
        res5 + 2048 * 81 * 5)), rel=1e-12)


def test_kernel_bounds():
    k3 = c.stem_bound(VOC)
    assert k3["bound_by"] == "operations"
    assert k3["ops"] == 2 * 8 * 608 * 1024 * 64 * (27 + 576)
    assert k3["bound_ms"] == pytest.approx(0.3887, abs=1e-4)
    k5 = c.roi_align_bound(COCO_R101)
    bins = 8 * 1000 * 14 * 14
    assert k5["ops"] == bins * 1024 * 49
    assert k5["bound_ms"] == pytest.approx(1.1743, abs=1e-4)
    assert k5["bytes"] == 8 * 50 * 84 * 1024 * 2 + 8 * 1000 * 16 + bins * 1024 * 2
    k6 = c.roi_align_bwd_bound(COCO_R101)
    assert k6["bound_ms"] == pytest.approx(0.1503, abs=1e-4)
    assert math.isclose(c.bound_ms(3.35e12, 1.0, 1.0)[0], 1e3)
