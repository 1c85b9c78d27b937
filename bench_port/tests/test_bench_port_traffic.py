"""The traffic generator: the same seed makes the same batches; another
seed the same sizes and gt counts in another order."""

import json
from pathlib import Path

import torch

from bench_port import harness, traffic

ROOT = Path(__file__).resolve().parents[2]


def pool(cell, seed, batches=2):
    c = harness.load_cell(ROOT, cell)
    t = dict(c.traffic, pool_batches=batches)
    cfg = harness.model_config(c.config)
    return traffic.make_pool(t, cfg, 2, c.config["gt_capacity"], seed, "cpu"), cfg


def test_same_seed_same_batches():
    a, _ = pool("vgg16_voc.train_b8", 2 ** 31 + 11)
    b, _ = pool("vgg16_voc.train_b8", 2 ** 31 + 11)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_other_seed_same_sizes_and_counts_in_another_order():
    a, cfg = pool("r101_c4_coco.train_b8", 5)
    b, _ = pool("r101_c4_coco.train_b8", 6)
    info_a = torch.cat([x["im_info"] for x in a])
    info_b = torch.cat([x["im_info"] for x in b])
    assert not torch.equal(info_a, info_b)
    key = lambda t: t[torch.argsort(t[:, 0] * 1e6 + t[:, 1] + t[:, 2] / 10)]
    assert torch.equal(key(info_a), key(info_b))
    n_a = torch.cat([x["gt_valid"] for x in a]).sum(-1).sort().values
    n_b = torch.cat([x["gt_valid"] for x in b]).sum(-1).sort().values
    assert torch.equal(n_a, n_b)
    for x in a:
        assert (x["im_info"][:, 0] <= cfg.image.pad_h).all()
        assert (x["im_info"][:, 1] <= cfg.image.pad_w).all()
        boxes, valid = x["gt_boxes"], x["gt_valid"]
        assert (boxes[..., 2][valid] <= x["im_info"][:, None, 1].expand_as(valid)[valid]).all()
        assert (boxes[..., 3][valid] <= x["im_info"][:, None, 0].expand_as(valid)[valid]).all()
        assert (x["gt_labels"][valid] >= 1).all() and (x["gt_labels"][valid] < 81).all()


def test_images_are_zero_outside_their_extent_and_sizes_follow_the_rule():
    a, _ = pool("vgg16_voc.detect_b8", 3)
    x = a[0]
    h, w = int(x["im_info"][0, 0]), int(x["im_info"][0, 1])
    assert x["images"][0, h:].abs().sum() == 0 and x["images"][0, :, w:].abs().sum() == 0
    info = torch.cat([y["im_info"] for y in a])
    # VOC: shorter side 600 unless the longer would pass 1000
    assert ((info[:, 0] == 600) | (info[:, 1] == 1000)).all()


def test_gt_count_means_follow_the_sources():
    for cell, mean in (("vgg16_voc.train_b8", 2.4), ("r101_c4_coco.train_b8", 7.3)):
        counts = json.loads((ROOT / "bench_port" / "workloads" / f"{cell}.json").read_text())
        q = traffic.quantiles(16 * 8, counts["gt"]["counts"])
        assert abs(q.mean() - mean) < 0.35, (cell, q.mean())
