#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``trcnn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name, power limit and compute mode), torch and
   CUDA versions;
2. build the CUDA kernels K1-K6 from ``trcnn_torch/csrc``, all at once;
3. each kernel against its plain PyTorch version on the card at the main
   paths' shapes (K1 batched over 8 images, an empty and a short image
   among them; K2 and K4 also at the ResNet-101-C4 pool, P=14 on a
   1024-channel map, and on the portrait map, 64x38; K3 also on the
   portrait canvas, 1024x608, at a batch of 8 in f32 and bf16), with both times (CUDA events around back-to-back
   calls after warm-up), the least time the card could take
   (``bound_ms``, from this run's inputs) and the kernel's share of it,
   and, for K3, the cuDNN composite's time beside the kernel's;
4. for each backbone (VGG-16, ResNet-101-C4), a small config through the
   port on the card and on the CPU (plain versions) with the same weights
   (ResNet-101's conv3 kernels and FrozenBN leaves randomised, so the
   residual branches are live): the detections must agree; one training
   forward with the same sampling draws must make the same sampling
   decisions and losses, and one training step (forward, backward,
   update) the same gradients and parameters within tolerance;
5. the main paths at full width, VOC, seeded weights, bf16 with float32
   master weights, uint8 608x1024 canvases, each with the launch counters
   set to 0 before it and read after it, for VGG-16 and then ResNet-101-C4:
   - detect, through ``trcnn_torch.entry.entry``: three one-image requests
     and one batch of 8; K1 exactly twice per call; K1-K3 must move on
     VGG-16, K1 and K2 on ResNet-101 and K3 not (its stem is a 7x7 conv);
   - train, through ``trcnn_torch.entry.train_entry``: one cold step and 6
     timed steps at batch 8; K1 exactly once per step; K1-K4 must move on
     VGG-16, K1, K2 and K4 on ResNet-101 and K3 not;
   ResNet-101's K2 and K4 are also timed on the inputs its batch of 8 and
   its train step give them (P=14);
6. per backbone, one float32 request and one float32 train step whose
   kernel inputs are captured and replayed through the plain versions;
7. the ResNet-101 train step with the res3-res5 FrozenBN leaves'
   gradients (through FrozenBatchNorm's written-out backward, and through
   plain autograd ops) and without them, in turns; one VGG-16 train step
   on a 4800x1440 canvas, whose 300x90 map takes K4's large-map variant
   (a counted path, its kernel calls replayed through the plain versions);
8. the data path at full width, through the CLIs' own code: a seeded VGG-16
   exported with ``export_chainer_npz`` and read back bit-equal through
   ``import_weights``; the evaluate CLI on ``SyntheticDetection(n=64)`` at
   batch 8 (both canvas buckets, 608x1024 and 1024x608) from that npz in
   float32 and bfloat16 with ``--write_dets``, and the seeded ResNet-101
   on 16 images, each with img/s, the loader's wait against the detect
   time per batch, and the device's busy share; the train CLI (4 steps at
   batch 8, the evaluator hook at step 4), its checkpoint read back by
   ``evaluate --checkpoint_dir``.  In each evaluation's dtype and in the
   train CLI, the first kernel call of each input shape is recorded and
   replayed through the plain versions; the forward CLI
   on one image file when the machine has an image library.  Each CLI run
   is a counted path (K1 exactly twice per detect call), and the CLIs'
   output goes to ``build/chip_smoke/``;
9. the COCO config (81 classes, 800x1344 canvas, 1000 test proposals):
   each kernel at its COCO shapes against its plain version with times and
   bounds (K1 on the 80 x 1000 epilogue at b=8 with and without the
   valid-prefix trim, and at the per-class launch shape; K2 and K4 on the
   50x84 map at P=7 and P=14 in bf16 and f32; K3 on both canvases); for
   each backbone the detect path (calibrated seeded weights, a request and
   a batch of 8) and the training step on the loader's multi-scale batches,
   each a counted path with its profile, peak memory, replayed kernel calls
   and, for detect, the epilogue on the model's own input; the evaluate CLI
   with ``--dataset coco`` on 16 images written as a COCO tree, f32 and
   bf16;
10. the two opt-in model modes: K5 and K6 (RoIAlign forward and backward,
    CUDA kernels for the JAX package's XLA RoIAlign) against their plain
    versions, chunked over RoIs: at every shape of
    ``tests/test_torch_kernels.py::ALIGN_SHAPES`` and at VGG-16 VOC (8, 300)
    P=7 C=512 and R101 COCO (8, 1000) P=14 C=1024, bf16 and f32 feat, K5
    bit-equal with float32 and with bfloat16 output, K6 (at 128 RoIs)
    within tolerance with float32 and bfloat16 g and bit-identical on a
    second call; at the two path shapes with times, bounds and the library
    yardstick (``F.grid_sample`` + ``F.avg_pool2d``, forward and backward);
    the small configs of both backbones with RoIAlign on
    the card against the CPU; the small int8 VGG-16 on the card against
    the CPU (with an exact stem, no int8 code apart at any quantized
    input); RoIAlign detect and train on VGG-16 VOC and on R101 COCO, each
    a counted path with its profile, peak memory, replayed kernel calls,
    and K5 / K6 checked and timed on the path's own inputs (K5 writing its
    crops in the compute dtype, K6 reading g in it); int8 VGG-16
    detect on VOC (a request and b=8) and COCO (b=8), counted, beside the
    bf16 model of the same weights in turns, profiled, and each quantized
    layer's int8 GEMM and whole int8 layer against its bf16 layer.
11. data parallelism (``trcnn_torch.parallel``): NCCL refuses two ranks on
    one device, so two gloo ranks share the card (this script re-runs
    itself as ``chip_smoke.py --dp-rank SPEC RANK``, its output kept in
    ``build/chip_smoke/dp.txt``): the small VGG-16 training config (2
    steps), VGG-16 VOC (3 steps) and ResNet-101 COCO (2 steps) float32
    training at a global batch of 8, each data-parallel step against one
    process's step from the same state on the same global batch (the
    replicas bit-identical, the sampled sets equal, losses and grad_norm
    within ``DP_RTOL``), with the all-reduce's time and bytes; the
    evaluator sharded over the two ranks on 37 images of both canvas
    buckets against one process (each image once, its detections equal,
    the same metrics on ground truth made from the one process's
    detections, mAP above 0); each rank a counted path whose kernel calls
    it replays through the plain versions on the card, as does the one
    process.  Then NCCL at world size 1: the train CLI with
    ``--distributed`` against the same run without it (its kernel calls
    replayed), and the step with and without the group in turns.
12. tensor parallelism (``trcnn_torch.parallel.tensor``): four gloo ranks
    on a 2 x 2 (data, model) grid share the card (``--dp-rank`` again):
    VGG-16 VOC float32 training at a global batch of 8, fc6 and fc7 cut in
    two, 3 steps, each against one process's step from the same state (the
    whole state gathered before it: sampled sets equal, losses and
    grad_norm within ``DP_RTOL``, each trained tensor's move within
    ``GRID_MOVE_RTOL`` of the one process's), replicas and every
    replicated parameter bit-identical, each rank's parameter bytes, its
    collectives' time and bytes per step by axis, its launches and its
    kernel calls replayed through the plain versions; the state written by
    the grid's Trainer restored bit-equal at 1 x 4 and at world size 1; one
    bfloat16 grid step against one process's (``GRID_BF16_RTOL``); then
    ``trcnn_torch.entry.dryrun_multichip(4)`` on the card.  The grid's
    ``Trainer.save`` gathers fc6/fc7 to rank 0 alone: each rank's device
    memory rise over it, ranks 1-3 below their own blocks and momentum.
13. the JAX package's last modules, after the data path: the convert CLI
    (to_flax, to_chainer, to_flax bit-equal on the full-width npz) and
    ``download --file``; the parity CLI on a VOC tree of 16 synthetic
    images (both buckets) from that npz: capture 8 goldens, compare with
    zero deltas, the failing gate's exit 2, each a counted path (its first
    run's kernel calls replayed); ``train_steps`` (K=4 at batch 8, a
    counted path, then in turns with 4 sequential steps); and
    ``preprocess_device`` on a 1024x1024 raw buffer (375x500 and 500x375
    images, card against CPU), its canvases through the detect path.

``chip_smoke.py --align-turns PARENT`` runs none of that: it times the
four RoIAlign paths (VGG-16 VOC and R101 COCO, detect and train, bf16) of
the tree unpacked at PARENT and of this script's tree in turns (parent,
this, this, parent), each turn a process of its own importing that tree's
``trcnn_torch``: host-clock ms, request latency, the device's busy share,
peak memory and kernel ms by group, one JSON line last.

Before the kernels' JSON record comes the card's name and power limit
again; the next-to-last line is the record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# kernel -> (csrc source, TPU kernel it replaces)
KERNELS = {
    "nms": ("trcnn_torch/csrc/nms.cu", "trcnn/ops/nms_pallas.py:216"),
    "roi_pool": ("trcnn_torch/csrc/roi_pool.cu", "trcnn/ops/roi_pool_pallas.py:451"),
    "roi_pool_bwd": ("trcnn_torch/csrc/roi_pool_bwd.cu", "trcnn/ops/roi_pool_pallas.py:571"),
    "stem": ("trcnn_torch/csrc/stem.cu", "trcnn/ops/stem_pallas.py:226"),
    # K4's variant for maps over 255 cells a side (the JAX model takes its
    # XLA pool there, trcnn/models/faster_rcnn.py:157-167)
    "roi_pool_bwd_large": ("trcnn_torch/csrc/roi_pool_bwd.cu",
                           "trcnn/ops/roi_pool_pallas.py:571"),
    # RoIAlign: the JAX package computes it in XLA (no Pallas kernel), its
    # backward by autodiff; K5 and K6 are CUDA kernels for that computation
    "roi_align": ("trcnn_torch/csrc/roi_align.cu", "trcnn/ops/roi_align.py:25 (XLA)"),
    "roi_align_bwd": ("trcnn_torch/csrc/roi_align_bwd.cu",
                      "trcnn/ops/roi_align.py:25 (XLA autodiff)"),
}
# the kernels each main path launches; it must launch each of them and no
# other (K3 is VGG-16's conv1 block only)
REQUIRED = {"vgg16 detect": ("nms", "roi_pool", "stem"),
            "vgg16 train": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            "resnet101 detect": ("nms", "roi_pool"),
            "resnet101 train": ("nms", "roi_pool", "roi_pool_bwd"),
            "vgg16 train 4800x1440": ("nms", "roi_pool", "roi_pool_bwd_large", "stem"),
            "vgg16 evaluate float32": ("nms", "roi_pool", "stem"),
            "vgg16 evaluate bfloat16": ("nms", "roi_pool", "stem"),
            "resnet101 evaluate": ("nms", "roi_pool"),
            "vgg16 train CLI": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            "vgg16 evaluate checkpoint": ("nms", "roi_pool", "stem"),
            "vgg16 forward CLI": ("nms", "roi_pool", "stem"),
            "vgg16 coco detect": ("nms", "roi_pool", "stem"),
            "vgg16 coco train": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            "resnet101 coco detect": ("nms", "roi_pool"),
            "resnet101 coco train": ("nms", "roi_pool", "roi_pool_bwd"),
            "vgg16 coco evaluate float32": ("nms", "roi_pool", "stem"),
            "vgg16 coco evaluate bfloat16": ("nms", "roi_pool", "stem"),
            "vgg16 align detect": ("nms", "roi_align", "stem"),
            "vgg16 align train": ("nms", "roi_align", "roi_align_bwd", "stem"),
            "resnet101 coco align detect": ("nms", "roi_align"),
            "resnet101 coco align train": ("nms", "roi_align", "roi_align_bwd"),
            "vgg16 int8 detect": ("nms", "roi_pool", "stem"),
            "vgg16 coco int8 detect": ("nms", "roi_pool", "stem"),
            # data parallel: each rank's launches
            "vgg16 dp train": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            "resnet101 coco dp train": ("nms", "roi_pool", "roi_pool_bwd"),
            "vgg16 dp evaluate": ("nms", "roi_pool", "stem"),
            "vgg16 train CLI nccl": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            "vgg16 train CLI without group": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            # tensor parallel: each rank's launches
            "vgg16 grid train": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            # the parity CLI (capture, compare, the failing gate), K steps per
            # call, preprocessing on the card
            "vgg16 parity run 1": ("nms", "roi_pool", "stem"),
            "vgg16 parity run 2": ("nms", "roi_pool", "stem"),
            "vgg16 parity run 3": ("nms", "roi_pool", "stem"),
            "vgg16 train_steps": ("nms", "roi_pool", "roi_pool_bwd", "stem"),
            "vgg16 preprocess_device detect": ("nms", "roi_pool", "stem")}
BACKBONES = ("vgg16", "resnet101")
NAMES = {"vgg16": "VGG-16", "resnet101": "ResNet-101-C4"}
STEM_F32_RTOL = 1e-4
ROI_BWD_F32_RTOL = 1e-5
# float32 gradients, card against CPU: each trained tensor within this
# share of its largest CPU gradient, the median share within 1e-3.  The
# port's own CPU gradients at 1 and 8 threads differ by up to 3.8e-3 on
# the ResNet-101 small config (tests/test_torch_resnet_train.py)
GRAD_RTOL = 1e-2
# one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, bf16 tensor-core
# and float32 (CUDA core) operations/s
HBM_BPS = 3.35e12
BF16_OPS = 989e12
F32_OPS = 67e12


def bound(nbytes: float, ops: float, ops_rate: float) -> dict:
    """The least time the card could take: the larger of moving the bytes
    at HBM rate and doing the operations at the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / ops_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def phase(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls after ``warmup`` calls, over the count, so that the host's work
    of each call overlaps the device's (an event pair around each single
    call also counts the host's time before its launch)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- K1 cases


def epilogue_case(n_classes: int, n_rois: int, seed: int):
    """The postprocess shape: each RoI's box jittered per class, grouped by
    class (class-major, as multiclass_nms flattens), tied scores."""
    boxes, scores, valid, _ = nms_case(n_rois, seed)
    rng = np.random.default_rng(seed + 100)
    jitter = rng.normal(0, 3, (n_classes, n_rois, 4)).astype(np.float32)
    cls_boxes = (boxes[None] + jitter).reshape(-1, 4)
    cls_boxes[:, 2:] = np.maximum(cls_boxes[:, 2:], cls_boxes[:, :2])
    cls_scores = np.round(rng.uniform(0, 1, n_classes * n_rois), 2).astype(np.float32)
    cls_valid = np.tile(valid, n_classes) & (cls_scores > 0.05)
    groups = np.repeat(np.arange(n_classes, dtype=np.int32), n_rois)
    return cls_boxes.astype(np.float32), cls_scores, cls_valid, groups


def nms_case(n: int, seed: int, im=(600.0, 1000.0)):
    """Boxes clustered like RPN proposals, scores with many exact ties, a few
    invalid entries, and pairs engineered within an ulp of IoU 0.7 / 0.3."""
    rng = np.random.default_rng(seed)
    h, w = im
    centres = rng.uniform([0, 0], [w, h], size=(max(n // 20, 1), 2))
    c = centres[rng.integers(0, len(centres), n)] + rng.normal(0, 8, (n, 2))
    size = rng.uniform(16, 200, (n, 2))
    boxes = np.concatenate([c - size / 2, c + size / 2], axis=1)
    # near-threshold pairs: equal squares shifted by d, IoU = (s - d) / (s + d)
    s = np.float32(99.0)
    for k, t in enumerate((0.7, 0.3) * 8):
        d0 = np.float32(s + 1.0) * np.float32((1 - t) / (1 + t))
        d = d0
        for _ in range(k % 4):
            d = np.nextafter(d, np.float32(np.inf) if k % 2 else np.float32(-np.inf))
        i = 2 * k
        if i + 1 >= n:
            break
        boxes[i] = (10 * k, 10, 10 * k + s, 10 + s)
        boxes[i + 1] = (10 * k + d, 10, 10 * k + d + s, 10 + s)
    boxes = np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    scores = np.round(rng.uniform(0, 1, n), 3).astype(np.float32)   # ties
    valid = rng.uniform(0, 1, n) > 0.03
    return boxes, scores, valid, None


def nms_batch(make, b: int, seed: int, few: int):
    """A batch of ``b`` images from ``make(seed)`` (boxes, scores, valid,
    groups): image 1 has no valid box, image 2 only its first ``few`` boxes
    valid, so that it keeps fewer than max_out."""
    cases = [make(seed + i) for i in range(b)]
    boxes, scores, valid = (np.stack([c[k] for c in cases]) for k in range(3))
    groups = None if cases[0][3] is None else np.stack([c[3] for c in cases])
    valid[1] = False
    valid[2, few:] = False
    return boxes, scores, valid, groups


def sorted_nms_inputs(boxes, scores, valid, groups, dev):
    """Score-sort each image on the device (stable), as nms_padded does."""
    import torch

    b = torch.from_numpy(boxes).to(dev)
    sc = torch.where(torch.from_numpy(valid).to(dev), torch.from_numpy(scores).to(dev),
                     torch.tensor(float("-inf"), device=dev))
    neg, order = torch.sort(-sc, dim=-1, stable=True)
    g = (None if groups is None
         else torch.gather(torch.from_numpy(groups).to(dev), -1, order).contiguous())
    return (torch.gather(b, -2, order[..., None].expand(*order.shape, 4)).contiguous(),
            (-neg > float("-inf")).contiguous(), g)


def check_nms_equal(args, thresh, max_out, what):
    """One K1 launch for the batch against the plain version per image."""
    from trcnn_torch.ops import nms

    kp, kv = nms.greedy_keep_cuda(*args[:2], thresh, max_out, args[2])
    pp, pv = nms.greedy_keep_plain(*args[:2], thresh, max_out, args[2])
    # both put index 0 in padding slots, so equal outputs are equal keep-sets
    mism = int((kp != pp).sum()) + int((kv != pv).sum())
    if mism:
        raise AssertionError(f"K1 keep-set differs from the plain version: {what}")
    kept = kv.sum(-1).tolist()
    if kept[1] != 0 or not 0 < kept[2] < max_out:
        raise AssertionError(f"K1 case lacks its empty or short image: {what}, kept {kept}")
    phase(f"  K1 {what}: kept {kept} per image, keep-sets and counts equal")
    return float(mism)


def nms_bound(args, t, max_out):
    """The greedy pass needs each kept box's predicate against every later
    box of its image (about 12 float32 operations each); bytes: boxes,
    flags and groups in, positions and counts out."""
    from trcnn_torch.ops import nms

    pos, kv = nms.greedy_keep_cuda(args[0], args[1], t, max_out, args[2])
    n = args[0].shape[-2]
    pairs = int(((n - 1 - pos.long()) * kv).sum())
    return pairs, bound(nbytes(args[0], args[1], args[2], pos) + 4 * pos.shape[0],
                        12.0 * pairs, F32_OPS)


# ---------------------------------------------------------------- K2 cases


def roi_case(b: int, r: int, seed: int, fh=38, fw=64, c=512):
    """Random RoIs plus clipped (partly outside the map), empty (beyond it),
    one-cell and 57 x 29-cell RoIs (the float32 quotient 57/7 decides a
    bound), in image coordinates (stride 16)."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-50, fw * 16, (b, r))
    y1 = rng.uniform(-50, fh * 16, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, 500, (b, r)),
                     y1 + rng.uniform(0, 400, (b, r))], axis=-1)
    rois[:, 0] = (3000, 3000, 3100, 3100)             # beyond the map: empty
    rois[:, 1] = (-200, -200, 2000, 1500)             # clipped on all sides
    rois[:, 2] = (160, 160, 160, 160)                 # one cell
    rois[:, 3] = (0, 16, 16 * 56, 16 * 29)            # 57 x 29 cells: fl(57/7)*7 > 57
    rois[:, 4] = (24, 40, 24 + 16 * 6, 40 + 16 * 28)  # half-pixel rounding
    feat = rng.standard_normal((b, fh, fw, c)).astype(np.float32)
    return feat, rois.astype(np.float32)


def bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_roi_equal(feat, rois, what, out_size=7):
    import torch

    from trcnn_torch.ops import roi_pool

    k = roi_pool.roi_max_pool_cuda(feat, rois, out_size)
    p = roi_pool.roi_max_pool_plain(feat, rois, out_size)
    if not torch.equal(bits(k), bits(p)):
        raise AssertionError(f"K2 is not bit-equal to the plain version: {what}")
    phase(f"  K2 {what}: bit-equal, {int((p == 0).all(-1).sum())} empty bins")
    return float((k.float() - p.float()).abs().max())


# ---------------------------------------------------------------- K3 cases


def stem_case(shape, seed: int, integer: bool = False):
    """Real-valued inputs at the image's scale, or integer-valued ones whose
    convolution sums are exact in float32 in any order (|x| <= 8, w1 in
    {-2..2}, w2 in {-2..2}/16, biases in {-4..4}: every partial sum is a
    multiple of 1/16 below 2^20)."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, shape)
        w1 = rng.integers(-2, 3, (64, 3, 3, 3))
        w2 = rng.integers(-2, 3, (64, 64, 3, 3)) / 16.0
        b1, b2 = rng.integers(-4, 5, 64), rng.integers(-4, 5, 64)
    else:
        x = rng.standard_normal(shape) * 50.0
        w1 = rng.standard_normal((64, 3, 3, 3)) / np.sqrt(27)
        w2 = rng.standard_normal((64, 64, 3, 3)) / np.sqrt(576)
        b1, b2 = rng.standard_normal(64) * 0.1, rng.standard_normal(64) * 0.1
    return tuple(np.asarray(a, np.float32) for a in (x, w1, b1, w2, b2))


def bf16_ulp(t):
    """Spacing of bfloat16 values at |t| (8 significant bits)."""
    import torch

    a = t.abs().float().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def stem_limit(p):
    """K3's tolerance against its plain output p: float32 within
    STEM_F32_RTOL of p's largest magnitude, bfloat16 within one bf16 ulp of
    it."""
    import torch

    scale = float(p.float().abs().max())
    if p.dtype == torch.float32:
        return STEM_F32_RTOL * scale
    return float(bf16_ulp(torch.tensor(scale)))


def check_stem(args, what, exact=False):
    """exact: bit-equal (integer-valued case, sums exact in any order).
    float32: within STEM_F32_RTOL of the output's largest magnitude, TF32
    off.  bfloat16: within one bf16 ulp of the output's largest magnitude;
    the share of elements beyond one ulp of their own value is printed (a
    conv1_1 activation that rounds the other way under another summation
    order is carried through conv1_2's 576-term sum into small outputs)."""
    import torch

    from trcnn_torch.ops import stem

    k = stem.stem_block1_cuda(*args)
    p = stem.stem_block1_plain(*args)
    err = (k.float() - p.float()).abs()
    scale = float(p.abs().max())
    if exact:
        ok = torch.equal(bits(k), bits(p))
        phase(f"  K3 {what}: {'bit-equal' if ok else 'NOT bit-equal'}, "
              f"max abs err {float(err.max()):.3e}")
    elif k.dtype == torch.float32:
        ok = float(err.max()) <= stem_limit(p)
        phase(f"  K3 {what}: max abs err {float(err.max()):.3e} "
              f"(limit {STEM_F32_RTOL} x {scale:.3e})")
    else:
        limit = stem_limit(p)
        ok = float(err.max()) <= limit
        own = err / bf16_ulp(torch.maximum(k.float().abs(), p.float().abs()))
        phase(f"  K3 {what}: max abs err {float(err.max()):.3e} (limit one bf16 "
              f"ulp at {scale:.3e} = {limit:.3e}); {int((own > 0).sum())} of "
              f"{own.numel()} differ, {int((own > 1).sum())} by more than one ulp "
              f"of their own value (max {float(own.max()):.1f})")
    if not ok:
        raise AssertionError(f"K3 disagrees with the plain version: {what}")
    return float(err.max())


# ---------------------------------------------------------------- K4 cases


def bwd_limit(p):
    """K4's and K6's tolerance against their plain output p with real-valued
    g: float32 within ROI_BWD_F32_RTOL of the largest |dfeat|, bfloat16
    within one bf16 ulp of it (the atomics add in another order)."""
    import torch

    scale = float(p.float().abs().max())
    if p.dtype == torch.float32:
        return ROI_BWD_F32_RTOL * scale
    return float(bf16_ulp(torch.tensor(scale)))


def check_roi_bwd(feat, rois, g, what, exact):
    """exact: bit-equal (integer-valued g: every float32 sum is exact in any
    order, so the winners and the sums must agree).  Otherwise float32
    within ROI_BWD_F32_RTOL of the largest |dfeat|, bf16 within one bf16
    ulp of it (the atomics add in another order).  The pool size is g's."""
    import torch

    from trcnn_torch.ops import roi_pool

    p_ = g.shape[2]
    k = roi_pool.roi_pool_backward_cuda(feat, rois, g, p_)
    p = roi_pool.roi_pool_backward_plain(feat, rois, g, p_)
    err = float((k.float() - p.float()).abs().max())
    scale = float(p.float().abs().max())
    if exact:
        ok = torch.equal(bits(k), bits(p))
        phase(f"  K4 {what}: {'bit-equal' if ok else 'NOT bit-equal'}, max abs err {err:.3e}")
    else:
        limit = bwd_limit(p)
        ok = err <= limit
        phase(f"  K4 {what}: max abs err {err:.3e} (limit {limit:.3e} at scale {scale:.3e})")
    if not ok:
        raise AssertionError(f"K4 disagrees with the plain version: {what}")
    return err


def roi_row(kernel, what, feat, rois, g=None, out_size=7, plain_iters=3):
    """K2 (g None) or K4 at one shape: the kernel's time, its share of the
    bound, the plain version's time (over ``plain_iters`` calls, one warm-up
    call before more than one) and the bound from this run's inputs (bytes:
    inputs read once, the output written once; operations: the window cells
    and, for K4, one add per non-empty bin, per channel)."""
    from trcnn_torch.ops import roi_pool

    b, h, w, c = feat.shape
    cells, bins = bin_cells(rois, h, w, out_size)
    if g is None:
        ms = cuda_time_ms(lambda: roi_pool.roi_max_pool_cuda(feat, rois, out_size))
        plain_ms = cuda_time_ms(lambda: roi_pool.roi_max_pool_plain(feat, rois, out_size),
                                warmup=int(plain_iters > 1), iters=plain_iters)
        out_bytes = b * rois.shape[1] * out_size * out_size * c * feat.element_size()
        bd = bound(nbytes(feat, rois) + out_bytes, cells * float(c), F32_OPS)
    else:
        ms = cuda_time_ms(lambda: roi_pool.roi_pool_backward_cuda(feat, rois, g, out_size))
        plain_ms = cuda_time_ms(
            lambda: roi_pool.roi_pool_backward_plain(feat, rois, g, out_size),
            warmup=int(plain_iters > 1), iters=plain_iters)
        bd = bound(nbytes(feat, rois, g, feat), (cells + bins) * float(c), F32_OPS)
    share = bd["bound_ms"] / ms * 100
    phase(f"  {kernel} time at {what}: kernel {ms:.4f} ms ({share:.1f}% of bound), plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return dict(shape=what, ms=ms, plain_ms=plain_ms, pct_of_bound=share, **bd)


def bin_cells(rois, h, w, out_size=7):
    """Feature cells summed over every bin of every RoI, and the number of
    non-empty bins: the work the RoI pool's data needs."""
    from trcnn_torch.ops import roi_pool

    hs, he, ws, we = roi_pool.roi_bin_bounds(rois, 1.0 / 16.0, out_size, h, w)
    bh = (he - hs).clamp(min=0)[..., :, None]
    bw = (we - ws).clamp(min=0)[..., None, :]
    cells = bh * bw
    return int(cells.sum()), int((cells > 0).sum())


# ---------------------------------------------------------------- phases


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    phase(smi)
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    phase(f"compute mode: {mode}")
    phase(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")


def phase_build():
    from trcnn_torch import _build

    secs, logs = _build.timed_build()
    phase(f"build: {secs:.1f} s, {len(logs)} kernels compiled into {_build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                phase(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev):
    import torch

    from trcnn_torch.ops import nms, roi_pool, stem

    rec = {}
    phase("kernels vs plain versions:")

    # K1, one launch per batch of 8: proposals 6000 -> 300 @0.7
    # (presorted), epilogue 20 x 300 -> 100 @0.3 (grouped, sorted here),
    # train 12000 -> 2000 @0.7; each with an empty and a short image
    err = 0.0
    cases = [("(8,6000)->300 @0.7", nms_batch(lambda sd: nms_case(6000, sd), 8, 1, 200),
              0.7, 300),
             ("grouped (8,20x300)->100 @0.3",
              nms_batch(lambda sd: epilogue_case(20, 300, sd), 8, 2, 60), 0.3, 100),
             ("(8,12000)->2000 @0.7", nms_batch(lambda sd: nms_case(12000, sd), 8, 3, 1500),
              0.7, 2000)]
    shapes = []
    for what, case, t, k in cases:
        args = sorted_nms_inputs(*case, dev)
        err = max(err, check_nms_equal(args, t, k, what))
        ms = cuda_time_ms(lambda: nms.greedy_keep_cuda(args[0], args[1], t, k, args[2]))
        plain_ms = cuda_time_ms(lambda: nms.greedy_keep_plain(args[0], args[1], t, k, args[2]),
                                warmup=1, iters=3)
        pairs, b1 = nms_bound(args, t, k)
        phase(f"  K1 time at {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b1['bound_ms']:.4f} ms ({b1['bound_by']}, {pairs} predicates)")
        shapes.append(dict(shape=what, ms=ms, plain_ms=plain_ms, **b1))
    # one image of the train shape alone, in the same call: one launch for 8
    # images must beat 8 launches of one
    one = [a[0] if a is not None else None for a in args]
    ms1 = cuda_time_ms(lambda: nms.greedy_keep_cuda(one[0], one[1], t, k, one[2]))
    phase(f"  K1 time at one image 12000->2000: {ms1:.4f} ms; the batch of 8 takes "
          f"{shapes[-1]['ms'] / ms1:.2f}x that")
    shapes.append(dict(shape="(1,12000)->2000 @0.7", ms=ms1))
    if shapes[2]["ms"] >= 8 * ms1:
        raise AssertionError("K1's one launch for 8 images is no faster than 8 launches of one")
    # the record keeps the train shape, the kernel's largest cost per step
    rec["nms"] = dict(max_abs_err=err, library_ms=None, shapes=shapes,
                      **{k: shapes[2][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})

    # K2: B=1 and B=8 x 300 RoIs on the VGG map (38 x 64 x 512), bf16 and f32
    err = 0.0
    for b in (1, 8):
        feat, rois = roi_case(b, 300, 10 + b)
        rois_t = torch.from_numpy(rois).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            feat_t = torch.from_numpy(feat).to(dev, dt)
            err = max(err, check_roi_equal(feat_t, rois_t, f"B={b} {dt}"))
    feat_t = torch.from_numpy(feat).to(dev, torch.bfloat16)
    k2_rows = [roi_row("K2", "(8,300) P=7 C=512 bf16 (detect)", feat_t, rois_t)]

    # K2 and K4 at the training shape, B=8 x 128 RoIs on the VGG map, f32 and
    # bf16; K4 with integer-valued g (bit-equal), on a tie-heavy map too, and
    # real-valued g
    feat, rois = roi_case(8, 128, 30)
    rng = np.random.default_rng(31)
    g_int = rng.integers(-4, 5, (8, 128, 7, 7, 512)).astype(np.float32)
    g_real = rng.standard_normal((8, 128, 7, 7, 512)).astype(np.float32)
    ties = rng.integers(0, 3, feat.shape).astype(np.float32)
    rois_t = torch.from_numpy(rois).to(dev)
    for what, f in (("", feat), (", tie-heavy map", ties)):
        for dt in (torch.bfloat16, torch.float32):
            err = max(err, check_roi_equal(torch.from_numpy(f).to(dev, dt), rois_t,
                                           f"B=8x128 {dt}{what} (train)"))
    k2_rows.append(roi_row("K2", "(8,128) P=7 C=512 bf16 (train)",
                           torch.from_numpy(feat).to(dev, torch.bfloat16), rois_t))
    err4 = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for what, f, g, exact in (("integer g", feat, g_int, True),
                                  ("integer g, tie-heavy map", ties, g_int, True),
                                  ("real g", feat, g_real, False)):
            feat_t = torch.from_numpy(f).to(dev, dt)
            g_t = torch.from_numpy(g).to(dev, dt)
            err4 = max(err4, check_roi_bwd(feat_t, rois_t, g_t, f"B=8x128 {dt} {what}", exact))
    k4_rows = [roi_row("K4", "(8,128) P=7 C=512 bf16 (train)", feat_t, rois_t, g_t)]
    ties_t = torch.from_numpy(ties).to(dev, torch.bfloat16)
    k4_rows.append(roi_row("K4", "(8,128) P=7 C=512 bf16, tie-heavy map", ties_t, rois_t, g_t))
    del feat_t, g_t, ties_t
    # the portrait map, 64 x 38 (the 1024 x 608 canvas), at the training
    # shape: K2 bit-equal, K4 bit-equal on integer g and within rounding on
    # real g, in f32 and bf16
    feat, rois = roi_case(8, 128, 34, fh=64, fw=38)
    rois_t = torch.from_numpy(rois).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        feat_t = torch.from_numpy(feat).to(dev, dt)
        err = max(err, check_roi_equal(feat_t, rois_t, f"B=8x128 64x38 map {dt}"))
        for what, g, exact in (("integer g", g_int, True), ("real g", g_real, False)):
            err4 = max(err4, check_roi_bwd(feat_t, rois_t, torch.from_numpy(g).to(dev, dt),
                                           f"B=8x128 64x38 map {dt} {what}", exact))
    del feat_t

    # the ResNet-101-C4 pool: P=14 on a (B, 38, 64, 1024) map, bf16; bit-equal
    # (K4: integer g, on a real and a tie-heavy map) and real g at B=2, timed
    # at B=8 (K2 300 RoIs, K4 128)
    feat, rois = roi_case(2, 128, 40, c=1024)
    rng = np.random.default_rng(41)
    rois_t = torch.from_numpy(rois).to(dev)
    feat_t = torch.from_numpy(feat).to(dev, torch.bfloat16)
    err = max(err, check_roi_equal(feat_t, rois_t, "B=2x128 P=14 C=1024 bf16", 14))
    g_int = torch.from_numpy(rng.integers(-4, 5, (2, 128, 14, 14, 1024)).astype(np.float32))
    ties_t = torch.from_numpy(rng.integers(0, 3, feat.shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    for what, f_t, g_t, exact in (
            ("integer g", feat_t, g_int, True), ("integer g, tie-heavy map", ties_t, g_int, True),
            ("real g", feat_t, torch.from_numpy(rng.standard_normal(g_int.shape)), False)):
        err4 = max(err4, check_roi_bwd(f_t, rois_t, g_t.to(dev, torch.bfloat16),
                                       f"B=2x128 P=14 C=1024 bf16 {what}", exact))
    del feat_t, ties_t, g_int
    feat, rois = roi_case(8, 300, 42, c=1024)
    feat_t = torch.from_numpy(feat).to(dev, torch.bfloat16)
    k2_rows.append(roi_row("K2", "(8,300) P=14 C=1024 bf16 (R101)", feat_t,
                           torch.from_numpy(rois).to(dev), out_size=14))
    torch.cuda.empty_cache()
    rois_t = torch.from_numpy(rois[:, :128].copy()).to(dev)
    g_t = torch.from_numpy(rng.standard_normal((8, 128, 14, 14, 1024)).astype(np.float32)).to(
        dev, torch.bfloat16)
    k4_rows.append(roi_row("K4", "(8,128) P=14 C=1024 bf16 (R101)", feat_t, rois_t, g_t, 14))
    del feat_t, g_t
    torch.cuda.empty_cache()
    # K4's large-map variant: 300 x 90 and 90 x 300 maps (a 4800 x 1440
    # canvas and its transpose), over 255 cells a side; bit-equal on integer
    # g (a tie-heavy map too) in f32 and bf16, real g within rounding, timed
    # at B=8 x 128 RoIs, 7x7 bins, 512 channels
    err_l, large_rows = 0.0, []
    for fh, fw in ((300, 90), (90, 300)):
        feat, rois = roi_case(2, 128, 50 + fh, fh=fh, fw=fw)
        rng = np.random.default_rng(51)
        rois_t = torch.from_numpy(rois).to(dev)
        g_int = rng.integers(-4, 5, (2, 128, 7, 7, 512)).astype(np.float32)
        ties = rng.integers(0, 3, feat.shape).astype(np.float32)
        for dt in (torch.float32, torch.bfloat16):
            if not roi_pool._bwd_plan(fh, fw, 4 if dt == torch.float32 else 2).large:
                raise AssertionError(f"a {fh} x {fw} map did not take K4's large-map variant")
            for what, f, g, exact in (
                    ("integer g", feat, g_int, True), ("integer g, tie-heavy map", ties, g_int, True),
                    ("real g", feat, rng.standard_normal(g_int.shape).astype(np.float32), False)):
                err_l = max(err_l, check_roi_bwd(
                    torch.from_numpy(f).to(dev, dt), rois_t, torch.from_numpy(g).to(dev, dt),
                    f"large map B=2x128 {fh}x{fw} {dt} {what}", exact))
        feat, rois = roi_case(8, 128, 52 + fh, fh=fh, fw=fw)
        feat_t = torch.from_numpy(feat).to(dev, torch.bfloat16)
        g_t = torch.from_numpy(rng.standard_normal((8, 128, 7, 7, 512)).astype(
            np.float32)).to(dev, torch.bfloat16)
        large_rows.append(roi_row("K4 large", f"(8,128) P=7 C=512 bf16 {fh}x{fw} map", feat_t,
                                  torch.from_numpy(rois).to(dev), g_t))
        del feat_t, g_t
        torch.cuda.empty_cache()

    main = ("ms", "plain_ms", "bound_ms", "bound_by")
    rec["roi_pool"] = dict(max_abs_err=err, library_ms=None, shapes=k2_rows,
                           **{k: k2_rows[0][k] for k in main})
    rec["roi_pool_bwd"] = dict(max_abs_err=err4, library_ms=None, shapes=k4_rows,
                               **{k: k4_rows[0][k] for k in main})
    rec["roi_pool_bwd_large"] = dict(max_abs_err=err_l, library_ms=None, shapes=large_rows,
                                     **{k: large_rows[0][k] for k in main})

    # K3: the full canvas, integer-valued (exact) and real-valued: one image
    # in f32 and bf16 (a request), a batch of 8 in bf16 (detect b=8, train);
    # the portrait canvas (1024 x 608: a width that is no multiple of the
    # 64-wide tiles) at a batch of 8 in f32 and bf16 (the evaluate CLI)
    err = 0.0
    for integer in (True, False):
        kind = "integer" if integer else "real"
        case = stem_case((8, 1024, 608, 3), 22, integer=integer)
        for dt in (torch.float32, torch.bfloat16):
            argsp = [torch.from_numpy(a).to(dev, dt) for a in case]
            err = max(err, check_stem(argsp, f"(8,1024,608,3) {dt} {kind} (portrait)",
                                      exact=integer))
        args8 = [torch.from_numpy(a).to(dev, torch.bfloat16)
                 for a in stem_case((8, 608, 1024, 3), 21, integer=integer)]
        err = max(err, check_stem(args8, f"(8,608,1024,3) {torch.bfloat16} "
                                         f"{kind}", exact=integer))
        case = stem_case((1, 608, 1024, 3), 20, integer=integer)
        for dt in (torch.float32, torch.bfloat16):
            args = [torch.from_numpy(a).to(dev, dt) for a in case]
            err = max(err, check_stem(args, f"(1,608,1024,3) {dt} "
                                            f"{'integer' if integer else 'real'}",
                                      exact=integer))
    # kernel and cuDNN composite (the plain version: conv, bias, ReLU, conv,
    # bias, ReLU, pool) in turns at each shape; the record keeps the batch's.
    # The kernel must beat the composite on the landscape canvas; on the
    # portrait canvas the comparison is printed
    shapes = []
    for what, a in (("(1,608,1024,3) bf16", args), ("(8,608,1024,3) bf16", args8),
                    ("(8,1024,608,3) bf16 (portrait)", argsp)):
        shapes.append(stem_row(what, a))
        if shapes[-1]["ms"] >= shapes[-1]["library_ms"] and "portrait" not in what:
            raise AssertionError(f"K3 is no faster than the cuDNN composite at {what}")
    del args8, argsp
    rec["stem"] = dict(max_abs_err=err, shapes=shapes, **shapes[1])
    del rec["stem"]["shape"]
    return rec


def stem_row(what, a):
    """K3 and the cuDNN composite (the plain version: conv, bias, ReLU,
    conv, bias, ReLU, pool) in turns on the bf16 inputs ``a``, with the
    bound: the kernel's time, the composite's (also its library time)."""
    from trcnn_torch.ops import stem

    k1 = cuda_time_ms(lambda: stem.stem_block1_cuda(*a), iters=9)
    l1 = cuda_time_ms(lambda: stem.stem_block1_plain(*a), iters=9)
    l2 = cuda_time_ms(lambda: stem.stem_block1_plain(*a), iters=9)
    k2 = cuda_time_ms(lambda: stem.stem_block1_cuda(*a), iters=9)
    ms, lib_ms = statistics.median([k1, k2]), statistics.median([l1, l2])
    hw = a[0].shape[0] * a[0].shape[1] * a[0].shape[2]
    b3 = bound(nbytes(*a) + hw // 4 * 64 * 2, 2.0 * hw * 64 * (27 + 576), BF16_OPS)
    phase(f"  K3 time at {what}: kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), cuDNN "
          f"composite {lib_ms:.4f} ms ({l1:.4f}, {l2:.4f}), bound {b3['bound_ms']:.4f} ms "
          f"({b3['bound_by']}); kernel {lib_ms / ms:.2f}x the composite's speed, "
          f"{b3['bound_ms'] / ms * 100:.1f}% of the bound")
    return dict(shape=what, ms=ms, plain_ms=lib_ms, library_ms=lib_ms, **b3)


def small_cfg(backbone: str):
    """The small detect configs: tests/test_golden_e2e.py's (VGG-16) and
    tests/test_cross_impl_resnet.py's (ResNet-101: 128 x 192 canvas, RPN
    width 64, 512 -> 48 proposals)."""
    from trcnn_torch.config import (AnchorConfig, FasterRCNNConfig, ImageConfig,
                                    ProposalConfig, TestTimeConfig)

    if backbone == "vgg16":
        return FasterRCNNConfig(head_hidden=32, rpn_channels=16,
                                proposals=ProposalConfig(pre_nms_topk_test=192,
                                                         post_nms_topk_test=24))
    return FasterRCNNConfig(backbone="resnet101", rpn_channels=64,
                            anchors=AnchorConfig(scales=(2.0, 4.0, 8.0)),
                            proposals=ProposalConfig(pre_nms_topk_test=512,
                                                     post_nms_topk_test=48),
                            image=ImageConfig(pad_h=128, pad_w=192),
                            test=TestTimeConfig(max_dets_per_class=32, max_dets_per_image=32))


def wake_residuals(model, gen) -> None:
    """As tests/test_cross_impl_resnet.py's fixture does, from ``gen``:
    every bottleneck's conv3 kernel normal(0, 0.02) (zero at init, which
    leaves each residual branch dead) and every FrozenBN leaf random (scale
    and var uniform in [0.5, 1.5), mean and bias normal(0, 0.1))."""
    import torch

    from trcnn_torch.models.resnet import Bottleneck, FrozenBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.conv3.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, FrozenBatchNorm):
                for t in (m.scale, m.var):
                    t.uniform_(0.5, 1.5, generator=gen)
                for t in (m.mean, m.bias):
                    t.normal_(0.0, 0.1, generator=gen)


def calibrate(model, images, info, head: bool) -> None:
    """Spread the RPN's scores and deltas (a 0.01-sigma init is
    tie-dominated) and, with ``head``, the head's class scores and deltas
    on fixed RoIs, as the JAX fixtures do."""
    import torch

    with torch.no_grad():
        feat = model.extractor(model._prepare(images, info))
        rpn = model.rpn(feat)
        model.rpn.rpn_cls_score.weight.mul_(2.0 / float(rpn.logits.std()))
        model.rpn.rpn_bbox_pred.weight.mul_(0.15 / float(rpn.deltas.std()))
        if head:
            rois = torch.stack([torch.tensor([10.0, 10.0, 80.0, 90.0]) + 3 * i
                                for i in range(8)]).expand(images.shape[0], 8, 4).to(images.device)
            cs, bp = model.roi_forward(feat, rois.contiguous())
            model.head.cls_score.weight.mul_(2.0 / float(cs.std()))
            model.head.bbox_pred.weight.mul_(0.1 / float(bp.std()))


def small_model(backbone: str, cfg, seed: int, images, info, head: bool):
    """The float32 CPU model of a small config, initialised from ``seed``;
    ResNet-101's residual branches woken; outputs spread (:func:`calibrate`)."""
    import torch

    from trcnn_torch.models import make_model

    gen = torch.Generator().manual_seed(seed)
    model = make_model(cfg, device="cpu").init(gen)
    if backbone == "resnet101":
        wake_residuals(model, gen)
    calibrate(model, images, info, head)
    return model


def phase_small_parity(dev, backbone: str, mode: str = "max"):
    """The small detect config through the port on the card and on the CPU
    with the same seeded weights, float32: VGG-16 on uint8 images with the
    init's head (score threshold 0.02), ResNet-101 on real-valued images
    with its outputs spread (the config's threshold); ``mode`` is the RoI
    mode ("max" or "align")."""
    import torch

    from trcnn_torch.models import make_model, postprocess

    cfg = with_mode(small_cfg(backbone), mode)
    rng = np.random.default_rng(42)
    if backbone == "vgg16":
        cpu = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(42)).eval()
        images = torch.from_numpy(rng.uniform(0, 256, (2, 64, 96, 3)).astype(np.uint8))
        info = torch.tensor([[60.0, 90.0, 1.2], [64.0, 80.0, 1.0]])
        thresh = 0.02
    else:
        images = torch.from_numpy((rng.standard_normal((2, 128, 192, 3)) * 40).astype(np.float32))
        info = torch.tensor([[120.0, 180.0, 1.2], [100.0, 160.0, 1.0]])
        cpu = small_model(backbone, cfg, 21, images, info, head=True).eval()
        thresh = None
    gpu = make_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    gpu.eval()
    with torch.no_grad():
        ref_raw = cpu.detect(images, info)
        ref = postprocess(ref_raw, info, cfg, score_thresh=thresh)
        raw = gpu.detect(images.to(dev), info.to(dev))
        got = postprocess(raw, info.to(dev), cfg, score_thresh=thresh)
    got_raw = [t.cpu() for t in raw]
    got = [t.cpu() for t in got]
    what = f"small {NAMES[backbone]} config, RoI {mode}"
    if not torch.equal(got_raw[1], ref_raw.roi_valid):
        raise AssertionError(f"{what}: roi_valid differs between card and CPU")
    torch.testing.assert_close(got_raw[0], ref_raw.rois, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got_raw[2], ref_raw.cls_prob, rtol=1e-4, atol=1e-5)
    if not (torch.equal(got[3], ref.valid) and torch.equal(got[2], ref.classes)):
        raise AssertionError(f"{what}: detections differ between card and CPU")
    torch.testing.assert_close(got[0], ref.boxes, rtol=1e-3, atol=1e-2)
    torch.testing.assert_close(got[1], ref.scores, rtol=1e-4, atol=1e-5)
    if backbone == "resnet101" and int(ref.valid.sum()) <= 3:
        raise AssertionError(f"{what}: degenerate, {int(ref.valid.sum())} detections")
    phase(f"{what}: card == CPU plain path, {int(ref.valid.sum())} detections")


def train_cfg(backbone: str = "vgg16"):
    """The small training configs: tests/test_cross_impl_train.py's
    (VGG-16), and for ResNet-101 the small detect config with its sampling
    capacities (tests/test_torch_resnet_train.py)."""
    from trcnn_torch.config import (AnchorConfig, FasterRCNNConfig, ImageConfig,
                                    ProposalConfig, ProposalTargetConfig)

    targets = ProposalTargetConfig(rois_per_image=16)
    if backbone == "resnet101":
        return small_cfg(backbone).replace(
            proposals=ProposalConfig(pre_nms_topk_train=512, post_nms_topk_train=64,
                                     pre_nms_topk_test=512, post_nms_topk_test=48),
            proposal_targets=targets)
    return FasterRCNNConfig(
        head_hidden=64, rpn_channels=64, head_dropout=0.0,
        anchors=AnchorConfig(scales=(2.0, 4.0, 8.0)),
        proposals=ProposalConfig(pre_nms_topk_train=512, post_nms_topk_train=64,
                                 pre_nms_topk_test=512, post_nms_topk_test=64),
        proposal_targets=targets, image=ImageConfig(pad_h=128, pad_w=192))


def train_proposals(model, images, im_info):
    """The proposals ``losses`` samples from, through the model's own
    ``propose``."""
    import torch

    with torch.no_grad():
        rpn = model.rpn(model.extractor(model._prepare(images, im_info)))
        return model.propose(rpn, im_info, train=True)


def phase_train_parity(dev, backbone: str):
    """The small training config on the card and on the CPU (plain
    versions), float32, the same weights and the same sampling draws
    (drawn on the CPU: a CUDA generator gives other numbers).  One
    training forward: anchor-target decisions and sample counts equal, the
    losses within 1e-4.  Then one training step on both (forward, backward,
    the Caffe-order update) from the same state on the CPU's proposals:
    the losses within 1e-4, the gradients within GRAD_RTOL, the parameters
    within 1e-5 of their largest magnitude plus the gradients' share, the
    frozen ones unchanged."""
    import torch

    from trcnn_torch.models import make_model
    from trcnn_torch.ops.anchors import shifted_anchors
    from trcnn_torch.targets import anchor_targets

    cfg = train_cfg(backbone)
    rng = np.random.default_rng(3)
    images = torch.from_numpy((rng.standard_normal((2, 128, 192, 3)) * 40).astype(np.float32))
    info = torch.tensor([[120.0, 180.0, 1.2], [100.0, 160.0, 1.0]])
    gtb = torch.zeros((2, 4, 4))
    gtb[0, :3] = torch.tensor([[10, 12, 70, 60], [90, 30, 170, 100], [40, 70, 110, 115.0]])
    gtb[1, :2] = torch.tensor([[20, 15, 95, 80], [100, 40, 150, 95.0]])
    gtl = torch.tensor([[3, 7, 12, 0], [5, 18, 0, 0]], dtype=torch.int32)
    gtv = torch.tensor([[True, True, True, False], [True, True, False, False]])
    cpu = small_model(backbone, cfg, 3, images, info, head=False)
    gpu = make_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    uni = cpu.draw_uniforms(2, (8, 12), 4, torch.Generator().manual_seed(4))
    args = (images, info, gtb, gtl, gtv)
    on_dev = lambda ts: [t.to(dev) for t in ts]  # noqa: E731
    what = f"small {NAMES[backbone]} config training"

    anchors = shifted_anchors(8, 12, cfg.anchors)
    at_c = anchor_targets(anchors, gtb, gtv, info[:, 0], info[:, 1], uni["at_fg"],
                          uni["at_bg"], cfg.anchor_targets)
    at_g = anchor_targets(*on_dev((anchors, gtb, gtv, info[:, 0], info[:, 1], uni["at_fg"],
                                   uni["at_bg"])), cfg.anchor_targets)
    if not (torch.equal(at_g.labels.cpu(), at_c.labels)
            and torch.equal(at_g.num_fg.cpu(), at_c.num_fg)):
        raise AssertionError(f"{what}: anchor-target decisions differ")

    gpu_uni = {k: v.to(dev) for k, v in uni.items()}
    with torch.no_grad():
        ref = cpu.losses(*args, generator=torch.Generator(), uniforms=uni)
        got = gpu.losses(*on_dev(args), generator=torch.Generator(device=dev), uniforms=gpu_uni)
    props_c = train_proposals(cpu, images, info)
    props_g = [t.cpu() for t in train_proposals(gpu, *on_dev((images, info)))]
    same = torch.equal(props_g[1], props_c[1]) and torch.allclose(props_g[0], props_c[0],
                                                                   rtol=1e-5, atol=1e-3)
    if not same:
        phase(f"  {what}: the card's proposals differ from the CPU's (a score "
              f"rounds differently); losses compared on the CPU's proposals")
        with torch.no_grad():
            got = gpu.losses(*on_dev(args), generator=torch.Generator(device=dev),
                             uniforms=gpu_uni, proposals=on_dev(props_c))
    worst = compare_losses(got, ref, what)
    phase(f"{what}: card == CPU plain path, proposals "
          f"{'equal' if same else 'differ'}, fg anchors {float(ref['num_fg_anchors'])}, "
          f"fg rois {float(ref['num_fg_rois'])}, losses within {worst:.2e} relative")
    train_step_parity(cpu, gpu, (args, on_dev(args)), (uni, gpu_uni),
                      (props_c, on_dev(props_c)), what)


def compare_losses(got, ref, what) -> float:
    """Sample counts equal, the four losses and their sum within 1e-4
    relative; the worst relative difference."""
    got, ref = ({k: float(v.detach()) for k, v in d.items()} for d in (got, ref))
    for k in ("num_fg_anchors", "num_fg_rois"):
        if got[k] != ref[k]:
            raise AssertionError(f"{what}: {k} {got[k]} vs CPU {ref[k]}")
    worst = 0.0
    for k in ("loss", "rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss"):
        rel = abs(got[k] - ref[k]) / abs(ref[k])
        worst = max(worst, rel)
        if rel > 1e-4:
            raise AssertionError(f"{what}: {k} {got[k]} vs CPU {ref[k]}")
    return worst


def train_step_parity(cpu, gpu, args, uniforms, proposals, what) -> None:
    """One training step of ``cpu`` and ``gpu`` (equal weights) from a zero
    momentum, each on its own device's copy of the same batch, uniforms
    and proposals: the losses, the gradients and the updated parameters
    compared (see :func:`phase_train_parity`)."""
    import torch

    from trcnn_torch.train import TrainState, learning_rate
    from trcnn_torch.train.optim import is_frozen

    before = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    res = []
    for i, model in enumerate((cpu, gpu)):
        model.train()
        state = TrainState.create(model)
        gen = torch.Generator(device=args[i][0].device)
        out = model.losses(*args[i], generator=gen, uniforms=uniforms[i], proposals=proposals[i])
        model.zero_grad(set_to_none=True)
        out["loss"].backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
        state.optimizer.step(0)
        res.append((out, grads, {k: p.detach().cpu() for k, p in model.named_parameters()}))
    (ref, g_c, p_c), (got, g_g, p_g) = res
    worst = compare_losses(got, ref, what + " step")
    backbone = cpu.cfg.backbone
    # gradients reach the trained tensors and, on ResNet-101, the FrozenBN
    # leaves of res3-res5 (never applied), and nothing of the frozen stem
    stem = [k for k in g_c if is_frozen(k, backbone) and not (
        "bn" in k and not k.startswith(("extractor.bn1", "extractor.res2")))]
    if g_c.keys() != g_g.keys() or stem:
        raise AssertionError(f"{what} step: gradients reach other tensors on the card")
    ratios = {k: float((g_g[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for k, w in g_c.items()}
    top = max(ratios, key=ratios.get)
    if ratios[top] > GRAD_RTOL or statistics.median(ratios.values()) > 1e-3:
        raise AssertionError(f"{what} step: gradient of {top} differs by {ratios[top]:.3e}")
    lr = learning_rate(cpu.cfg.optim, 0)
    for k, w in p_c.items():
        if is_frozen(k, backbone):
            if not (torch.equal(w, before[k]) and torch.equal(p_g[k], before[k])):
                raise AssertionError(f"{what} step: frozen {k} moved")
            continue
        slack = (1 + (w.dim() <= 1)) * lr * GRAD_RTOL * float(g_c[k].abs().max())
        if torch.equal(w, before[k]) or float((p_g[k] - w).abs().max()) > (
                1e-5 * float(w.abs().max()) + slack):
            raise AssertionError(f"{what} step: {k} after the update differs from the CPU's")
    phase(f"{what} step: card == CPU plain path, losses within {worst:.2e}, gradients within "
          f"{ratios[top]:.2e} of the largest ({top}; median "
          f"{statistics.median(ratios.values()):.2e} over {len(ratios)} tensors), "
          f"parameters within tolerance, {sum(is_frozen(k, backbone) for k in p_c)} frozen "
          f"unchanged")


# kernel-name fragments -> what they are, for the profile's breakdown
KERNEL_GROUPS = (("trcnn_nms", "K1 nms"), ("roi_pool_fwd", "K2 roi_pool"),
                 ("roi_pool_bwd", "K4 roi_pool_bwd"), ("stem_", "K3 stem"),
                 ("roi_align_fwd", "K5 roi_align"), ("roi_align_bwd", "K6 roi_align_bwd"),
                 ("gemm_s8", "int8 GEMM"),
                 ("imma", "int8 GEMM"),
                 ("gemm", "matmul/conv"), ("conv", "matmul/conv"), ("xmma", "matmul/conv"),
                 ("cutlass", "matmul/conv"), ("nvjet", "matmul/conv"), ("cudnn", "matmul/conv"))


def profile_window(run, n, what, stages=(), top_all=False):
    """``run`` n times under torch.profiler: device kernel time per call by
    group, the largest other kernels, and the device's busy share (the union
    of kernel intervals over the span from the first kernel's start to the
    last one's end).  ``stages`` names profiler spans that ``run`` opens;
    each one's kernel time is printed (:func:`phase_split`); ``top_all``
    also prints the largest kernels of every group by name.  Prints "no
    device time" if the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    events = prof.events()
    # without the spans' device-side copies, which are no kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.name not in stages]
    if not kernels:
        phase(f"  profile {what}: the profiler saw no device time")
        return
    busy, span = kernel_union(kernels)
    groups, other = kernel_split(kernels, n)
    phase(f"  profile {what}, {n} calls: device span {span / 1e3 / n:.3f} ms per call, busy "
          f"{busy / span * 100:.1f}%; kernel ms per call: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    phase("    largest other kernels: " + "; ".join(f"{k} {v:.3f}" for k, v in top))
    if top_all:
        names = {}
        for e in kernels:
            names[e.name[:70]] = (names.get(e.name[:70], 0.0)
                                  + (e.time_range.end - e.time_range.start) / 1e3 / n)
        top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
        phase("    largest kernels: " + "; ".join(f"{k} {v:.3f}" for k, v in top))
    if stages:
        phase_split(events, stages, n, sum(groups.values()))


def kernel_union(kernels):
    """(the union of the kernels' intervals, the span from the first one's
    start to the last one's end), in the profiler's microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo, max(e for _, e in spans) - spans[0][0]


def kernel_split(kernels, n):
    """Device kernel ms per call by group (``KERNEL_GROUPS``, else
    "other"), and the "other" kernels' ms by name."""
    groups, other = {}, {}
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) / 1e3 / n
        g = next((label for frag, label in KERNEL_GROUPS if frag in e.name.lower()), None)
        if g is None:
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + t
            g = "other"
        groups[g] = groups.get(g, 0.0) + t
    return groups, other


def phase_split(events, stages, n, total_ms):
    """Each stage's device kernel time per call, beside the span's host
    time.  A kernel counts for a stage when the host op that launched it
    starts inside the stage's span, on any thread (autograd runs the
    backward ops on its own device thread while the caller waits inside
    the span).  The profiler links no host op to a kernel launched through
    ctypes, so the port's own kernels (K1-K4, in the breakdown above) stay
    out of the stages, in the remainder."""
    import torch

    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [e for e in cpu if e.name in stages]
    kernel_ms = {s: 0.0 for s in stages}
    host_ms = {s: 0.0 for s in stages}
    for sp in spans:
        host_ms[sp.name] += (sp.time_range.end - sp.time_range.start) / 1e3 / n
    for op in cpu:
        if op.name in stages or not op.kernels:
            continue
        hit = next((sp for sp in spans
                    if sp.time_range.start <= op.time_range.start <= sp.time_range.end), None)
        if hit is not None:
            kernel_ms[hit.name] += sum(k.duration for k in op.kernels) / 1e3 / n
    phase("    stage split per call, kernels of torch ops (kernel ms, host ms of the span): "
          + ", ".join(f"{s.rsplit('.', 1)[-1]} {kernel_ms[s]:.3f}, {host_ms[s]:.3f}"
                      for s in stages)
          + f"; linked to no op in a span {total_ms - sum(kernel_ms.values()):.3f}")


def check_dets(dets, b, d=100):
    import torch

    shapes = {"boxes": (b, d, 4), "scores": (b, d), "classes": (b, d), "valid": (b, d)}
    for name, shape in shapes.items():
        t = getattr(dets, name)
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not (torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all()):
        raise AssertionError("non-finite detections")
    if int(dets.valid.sum()) == 0:
        raise AssertionError("no detections")


def require_launches(path, launches):
    """The path launched each of its kernels (``REQUIRED``) and no other."""
    missing = [k for k in REQUIRED[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {path} path never launched {missing}")
    extra = [k for k, n in launches.items() if n and k not in REQUIRED[path]]
    if extra:
        raise AssertionError(f"the {path} path launched {extra}, which it must not")


def require_nms_launches(what, call, want):
    """K1 launches once per batch: count its launches around one call."""
    import torch

    from trcnn_torch import _build

    _build.reset_launch_counts()
    call()
    torch.cuda.synchronize()
    got = _build.launch_counts["nms"]
    if got != want:
        raise AssertionError(f"{what} launched K1 {got} times, expected {want}")
    phase(f"  {what}: K1 launched {got} times in one call")


def with_mode(cfg, mode: str):
    """``cfg`` with ``roi.mode`` set to ``mode`` ("max" or "align")."""
    import dataclasses

    return cfg.replace(roi=dataclasses.replace(cfg.roi, mode=mode))


def path_name(backbone: str, kind: str, mode: str = "max", coco: bool = False) -> str:
    """The ``REQUIRED`` key of a path: e.g. "resnet101 coco align train"."""
    return " ".join([backbone] + ["coco"] * coco + [mode] * (mode != "max") + [kind])


def phase_slice(dev, backbone: str, rec, mode: str = "max"):
    """The full-width detect path: 3 requests and a batch of 8 with the
    launch counts read, the latencies, the profile; for ResNet-101, K2
    timed on the inputs of its batch of 8 (:func:`path_kernel_rows`).
    ``mode="align"``: the VOC config with RoIAlign (its im_info the
    canvas minus 4 pixels at unit scale), K5 checked and timed on the
    batch's own inputs (:func:`path_align_rows`)."""
    import torch

    from trcnn_torch import _build
    from trcnn_torch.config import voc_config
    from trcnn_torch.entry import entry

    t0 = time.perf_counter()
    cfg = None if mode == "max" else with_mode(voc_config().replace(backbone=backbone), mode)
    fn, (model, image, im_info) = entry(dev, cfg=cfg, backbone=backbone)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase(f"slice: VOC {NAMES[backbone]} bf16, RoI {model.cfg.roi.mode} {model.pool_size}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(7)
    requests = [torch.randint(0, 256, image.shape, dtype=torch.uint8, generator=gen,
                              device=dev) for _ in range(3)]
    images8 = torch.randint(0, 256, (8,) + image.shape[1:], dtype=torch.uint8,
                            generator=gen, device=dev)
    im_info8 = im_info.expand(8, 3).contiguous()

    _build.reset_launch_counts()
    lat = []
    for x in requests:
        t0 = time.perf_counter()
        dets = fn(model, x, im_info)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        check_dets(dets, 1)
    dets8 = fn(model, images8, im_info8)
    torch.cuda.synchronize()
    check_dets(dets8, 8)
    launches = dict(_build.launch_counts)
    phase(f"  launches over 3 requests + one batch of 8: {launches}")
    require_launches(path_name(backbone, "detect", mode), launches)
    for b, (x, info) in ((1, (requests[0], im_info)), (8, (images8, im_info8))):
        require_nms_launches(f"detect b={b}", lambda: fn(model, x, info), 2)

    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(model, requests[0], im_info)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    b8 = []
    for _ in range(4):
        t0 = time.perf_counter()
        fn(model, images8, im_info8)
        torch.cuda.synchronize()
        b8.append(time.perf_counter() - t0)
    phase(f"  request latency ms (first three, cold first): "
          f"{', '.join(f'{v:.2f}' for v in lat)}; warm median {statistics.median(warm):.2f}")
    phase(f"  b=8: {statistics.median(b8) * 1e3:.2f} ms per batch, "
          f"{8 / statistics.median(b8):.2f} img/s")
    profile_window(lambda: fn(model, images8, im_info8), 3, "detect b=8")
    phase(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if mode == "align":
        path_align_rows(rec, lambda: fn(model, images8, im_info8), f"{NAMES[backbone]} VOC "
                        f"align detect b=8")
    elif backbone == "resnet101":
        path_kernel_rows(rec, lambda: fn(model, images8, im_info8), "R101 detect b=8")
    else:
        # the trim's cost at the VOC shape: one read of a count per epilogue
        with torch.inference_mode():
            raw = model.detect(images8, im_info8)
        epilogue_report(raw, im_info8, model.cfg, "VOC VGG-16 seeded", rec)
        del raw
    del model
    torch.cuda.empty_cache()
    return launches


def check_step(m, step):
    import torch

    vals = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"step {step}: non-finite metrics {vals}")
    if not (vals["rpn_bbox_loss"] > 0 and vals["bbox_loss"] > 0 and vals["num_fg_rois"] > 0):
        raise AssertionError(f"step {step}: degenerate losses {vals}")
    return vals


def phase_train(dev, backbone: str, rec, mode: str = "max"):
    """The full-width training step through train_entry: one cold step, 6
    timed ones; the parameters move after the first, the frozen ones never;
    then 3 profiled steps, split into the step's own forward / backward /
    optimizer spans; for ResNet-101, K2 and K4 timed on one step's inputs
    (:func:`path_kernel_rows`).  ``mode="align"``: the VOC config with
    RoIAlign, K5 and K6 checked and timed on one step's own inputs
    (:func:`path_align_rows`)."""
    import torch

    from trcnn_torch import _build
    from trcnn_torch.config import voc_config
    from trcnn_torch.entry import train_entry
    from trcnn_torch.train.optim import is_frozen
    from trcnn_torch.train.step import STAGES

    t0 = time.perf_counter()
    cfg = None if mode == "max" else with_mode(voc_config().replace(backbone=backbone), mode)
    step_fn, (state, batch) = train_entry(dev, cfg=cfg, backbone=backbone)
    torch.cuda.synchronize()
    model = state.model
    phase(f"train: VOC {NAMES[backbone]} RoI {model.cfg.roi.mode}, bf16 compute, f32 master "
          f"weights, batch "
          f"{batch['images'].shape[0]} uint8 {tuple(batch['images'].shape[1:3])}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launch_counts()
    times, logs = [], []
    for i in range(7):
        t0 = time.perf_counter()
        m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logs.append(check_step(m, i))
        if i == 0:
            for k, p in model.named_parameters():
                moved = not torch.equal(p.detach(), before[k])
                if moved == is_frozen(k, backbone):
                    raise AssertionError(f"after step 1, {k} {'moved' if moved else 'did not move'}")
    launches = dict(_build.launch_counts)
    frozen = [k for k, p in model.named_parameters() if is_frozen(k, backbone)]
    if any(not torch.equal(model.get_parameter(k), before[k]) for k in frozen):
        raise AssertionError("a frozen parameter moved within 7 steps")
    phase(f"  launches over 7 train steps: {launches}; {len(frozen)} frozen parameters "
          f"unchanged")
    require_launches(path_name(backbone, "train", mode), launches)
    require_nms_launches("train step b=8", lambda: step_fn(state, batch), 1)
    for i, v in enumerate(logs):
        phase(f"  step {i}: " + ", ".join(f"{k} {x:.5g}" for k, x in v.items()))
    warm = statistics.median(times[1:])
    phase(f"  step ms: cold {times[0]:.2f}, warm {', '.join(f'{t:.2f}' for t in times[1:])}; "
          f"median {warm:.2f} ms, {batch['images'].shape[0] / warm * 1e3:.2f} img/s")
    phase(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    profile_window(lambda: step_fn(state, batch), 3, "train step b=8", STAGES)
    if mode == "align":
        path_align_rows(rec, lambda: step_fn(state, batch), f"{NAMES[backbone]} VOC align "
                        f"train b=8")
    elif backbone == "resnet101":
        path_kernel_rows(rec, lambda: step_fn(state, batch), "R101 train b=8")
    del model, state, before
    torch.cuda.empty_cache()
    return launches


def signature(args):
    """A kernel call's input shapes, dtypes and other arguments."""
    import torch

    return tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else a for a in args)


@contextlib.contextmanager
def recording(captured, first_of_shape=False):
    """Wrap every kernel wrapper so that each call's inputs (cloned) and
    output land in ``captured[name]``; with ``first_of_shape``, only the
    first K2-K6 call of each input signature (every K1 call)."""
    import torch

    from trcnn_torch.ops import nms, roi_align, roi_pool, stem

    targets = {"nms": (nms, "greedy_keep_cuda"), "roi_pool": (roi_pool, "roi_max_pool_cuda"),
               "roi_pool_bwd": (roi_pool, "roi_pool_backward_cuda"),
               "stem": (stem, "stem_block1_cuda"),
               "roi_align": (roi_align, "roi_align_cuda"),
               "roi_align_bwd": (roi_align, "roi_align_backward_cuda")}
    originals, seen = {}, set()
    for key, (mod, name) in targets.items():
        orig = originals[key] = getattr(mod, name)

        def wrapped(*args, _orig=orig, _key=key):
            out = _orig(*args)
            sig = (_key, signature(args))
            if not first_of_shape or _key == "nms" or sig not in seen:
                seen.add(sig)
                captured.setdefault(_key, []).append(
                    ([a.clone() if torch.is_tensor(a) else a for a in args], out))
            return out

        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for key, (mod, name) in targets.items():
            setattr(mod, name, originals[key])


def replay(captured, what) -> str:
    """Each captured call through its plain version: K1 equal, K2 and K5
    bit-equal, K3, K4 and K6 within their tolerances in the call's dtype
    (``stem_limit``, ``bwd_limit``).  Prints and returns the summary."""
    import torch

    from trcnn_torch.ops import nms, roi_align, roi_pool, stem

    for args, (kp, kv) in captured.get("nms", []):
        pp, pv = nms.greedy_keep_plain(*args)
        if not (torch.equal(kv, pv) and torch.equal(kp, pp)):
            raise AssertionError(f"K1 differs from plain on the {what}'s inputs")
    for args, out in captured.get("roi_pool", []):
        if not torch.equal(bits(out), bits(roi_pool.roi_max_pool_plain(*args))):
            raise AssertionError(f"K2 differs from plain on the {what}'s inputs")
    for args, out in captured.get("roi_align", []):
        if not torch.equal(bits(out), bits(roi_align.roi_align_plain(*args))):
            raise AssertionError(f"K5 differs from plain on the {what}'s inputs")
        torch.cuda.empty_cache()
    worst = {}
    for key, plain, limit in (("stem", stem.stem_block1_plain, stem_limit),
                              ("roi_pool_bwd", roi_pool.roi_pool_backward_plain, bwd_limit),
                              ("roi_align_bwd", roi_align.roi_align_backward_plain,
                               bwd_limit)):
        for args, out in captured.get(key, []):
            p = plain(*args)
            err, lim = float((out.float() - p.float()).abs().max()), limit(p)
            if err > lim:
                raise AssertionError(f"{key} differs from plain on the {what}'s inputs "
                                     f"{signature(args)[0]}: {err} > {lim}")
            worst[key] = max(worst.get(key, 0.0), err / lim if lim else 0.0)
    shapes = {k: sorted({str(tuple(a[0].shape) if torch.is_tensor(a[0]) else a[0]) for a, _ in v})
              for k, v in captured.items() if k != "nms"}
    msg = (f"{what}: captured {', '.join(f'{k} x{len(v)}' for k, v in captured.items())}; "
           f"plain replay agrees (K1 equal, K2 and K5 bit-equal"
           + "".join(f", {k} at most {w:.2f} of its limit" for k, w in worst.items())
           + f"); feat shapes {shapes}")
    phase(msg)
    return msg


def path_kernel_rows(rec, call, what):
    """One more call of a path with K2's and K4's inputs recorded (after
    its launch counts were read): each kernel checked against its plain
    version on them (K2 bit-equal; K4 within one bf16 ulp of the largest
    |dfeat|, or ROI_BWD_F32_RTOL in float32) and timed on them
    (:func:`roi_row`); the rows join the kernel's ``shapes``."""
    import torch

    captured = {}
    with recording(captured):
        call()
        torch.cuda.synchronize()
    for key, kernel in (("roi_pool", "K2"), ("roi_pool_bwd", "K4")):
        for args, _ in captured.get(key, []):
            feat, rois, g = args[0], args[1], (args[2] if key == "roi_pool_bwd" else None)
            p = args[-2]
            shape = (f"{tuple(rois.shape[:2])} P={p} C={feat.shape[-1]} "
                     f"{str(feat.dtype).split('.')[-1]} ({what} inputs)")
            if g is None:
                err = check_roi_equal(feat, rois, shape, p)
            else:
                err = check_roi_bwd(feat, rois, g, shape, exact=False)
            row = roi_row(kernel, shape, feat, rois, g, p)
            rec[key]["shapes"].append(row)
            rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"], err)
    del captured
    torch.cuda.empty_cache()


def path_align_rows(rec, call, what):
    """One more call of an align path with K5's and K6's inputs recorded
    (the first call of each input shape, after its launch counts were
    read): K5 must write its crops in the features' (the compute) dtype and
    K6 get g in it, so a bf16 path holds no float32 crop tensor and casts
    none; each kernel checked against its plain version on them
    (:func:`check_align`, :func:`check_align_bwd`) and timed on them
    (:func:`align_row`); the rows join the kernel's ``shapes``."""
    import torch

    captured = {}
    with recording(captured, first_of_shape=True):
        call()
        torch.cuda.synchronize()
    for args, out in captured.get("roi_align", []):
        feat, rois, p, od = args[0], args[1], args[2], args[5]
        if out.dtype != feat.dtype:
            raise AssertionError(f"{what}: K5 wrote {out.dtype} crops from {feat.dtype} features")
        shape = (f"{tuple(rois.shape[:2])} P={p} C={feat.shape[-1]} "
                 f"{str(feat.dtype).split('.')[-1]} on {feat.shape[1]}x{feat.shape[2]} "
                 f"({what} inputs)")
        rec["roi_align"]["max_abs_err"] = max(rec["roi_align"]["max_abs_err"],
                                              check_align(feat, rois, shape, p, od))
        rec["roi_align"]["shapes"].append(align_row("K5", shape, feat, rois, out_size=p,
                                                    out_dtype=od))
        torch.cuda.empty_cache()
    for args, _ in captured.get("roi_align_bwd", []):
        fshape, fdtype, rois, g, p = args[:5]
        if g.dtype != fdtype:
            raise AssertionError(f"{what}: K6 got {g.dtype} g for {fdtype} features")
        feat = torch.empty(fshape, dtype=fdtype, device=g.device)
        shape = (f"{tuple(rois.shape[:2])} P={p} C={fshape[-1]} {str(fdtype).split('.')[-1]} "
                 f"on {fshape[1]}x{fshape[2]} ({what} inputs)")
        rec["roi_align_bwd"]["max_abs_err"] = max(rec["roi_align_bwd"]["max_abs_err"],
                                                  check_align_bwd(feat, rois, g, shape))
        rec["roi_align_bwd"]["shapes"].append(align_row("K6", shape, feat, rois, g, p))
        torch.cuda.empty_cache()
    del captured
    torch.cuda.empty_cache()


def phase_capture(dev, backbone: str):
    """One float32 request and one float32 train step (batch 2); each
    kernel's actual inputs are recorded and replayed through its plain
    version."""
    import torch

    from trcnn_torch.entry import entry, train_entry

    name = NAMES[backbone]
    captured = {}
    with recording(captured):
        fn, (model, image, im_info) = entry(dev, dtype=torch.float32, backbone=backbone)
        dets = fn(model, image, im_info)
        torch.cuda.synchronize()
    check_dets(dets, 1)
    del model
    if set(captured) != set(REQUIRED[f"{backbone} detect"]):
        raise AssertionError(f"f32 {name} request reached {sorted(captured)}")
    replay(captured, f"f32 {name} request")

    captured = {}
    with recording(captured):
        step_fn, (state, batch) = train_entry(dev, dtype=torch.float32, batch_size=2,
                                              backbone=backbone)
        check_step(step_fn(state, batch), 0)
        torch.cuda.synchronize()
    del state
    if set(captured) != set(REQUIRED[f"{backbone} train"]):
        raise AssertionError(f"f32 {name} train step reached {sorted(captured)}")
    pools = {args[-2] for key in ("roi_pool", "roi_pool_bwd") for args, _ in captured[key]}
    if pools != {14 if backbone == "resnet101" else 7}:
        raise AssertionError(f"f32 {name} train step pooled at {pools}")
    replay(captured, f"f32 {name} train step (RoI pool {pools.pop()})")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- data path


def log_file(name, text):
    """``text`` into build/chip_smoke/<name> (the CLIs' own output)."""
    import os

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "a") as f:
        f.write(text)


def quiet(fn, argv):
    """A CLI's ``fn(argv)`` with its standard output kept in a log file."""
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = fn(argv)
    log_file("cli.txt", f"$ {fn.__module__}.{fn.__name__} {' '.join(argv)}\n{text.getvalue()}")
    return out


def count_path(path, by_path, call):
    """Launch counts set to 0 just before ``call()`` and read just after:
    the path must launch exactly its kernels (``REQUIRED``)."""
    import torch

    from trcnn_torch import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    require_launches(path, launches)
    by_path[path] = launches
    return out, launches


def busy_over(run):
    """One call of ``run`` under torch.profiler: (the union of its kernel
    intervals, the host wall time of the call, kernel ms by group), in
    ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("the profiler saw no device time")
    return kernel_union(kernels)[0] / 1e3, wall * 1e3, kernel_split(kernels, 1)[0]


def phase_weights(dev, tmp):
    """A seeded VGG-16 (graded class biases, so that random weights make
    detections) exported to a Chainer npz with the port's
    ``export_chainer_npz`` and imported back through ``import_weights``:
    bit-equal.  Returns the npz path and the state_dict."""
    import os

    import torch

    from trcnn_torch.config import voc_config
    from trcnn_torch.convert_chainer import export_chainer_npz
    from trcnn_torch.models import make_model
    from trcnn_torch.weights import import_weights

    cfg = voc_config()
    model = make_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(11))
    with torch.no_grad():
        model.head.cls_score.bias.copy_(torch.linspace(-3.0, 3.0, cfg.num_classes))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    path = os.path.join(tmp, "VGG16_seeded.npz")
    t0 = time.perf_counter()
    export_chainer_npz(sd, path, cfg)
    back = import_weights(path, cfg)
    secs = time.perf_counter() - t0
    bad = [k for k in sd if k not in back or not torch.equal(bits(back[k]), bits(sd[k]))]
    if bad or back.keys() != sd.keys():
        raise AssertionError(f"export -> import_weights changed {bad[:5]}")
    phase(f"weights: seeded VGG-16 -> export_chainer_npz ({os.path.getsize(path) / 2**20:.0f} "
          f"MiB) -> import_weights: {len(sd)} tensors bit-equal ({secs:.1f} s)")
    return path, sd


def print_eval(what, res, busy=None):
    t = res["timing"]
    nb = sum(t["batches"].values())
    buckets = ", ".join(f"{h}x{w}: {n}" for (h, w), n in sorted(t["batches"].items()))
    metric = ", ".join(f"{k[len('eval_'):]} {v:.4f}" for k, v in res["metrics"].items()
                       if k in ("eval_mAP", "eval_AP", "eval_AP50", "eval_AP75"))
    line = (f"  {what}: {res['images']} images in {nb} batches of 8 ({buckets}), "
            f"{metric}; {res['images'] / res['seconds']:.2f} img/s end to end; "
            f"per batch: loader wait {t['wait_s'] / nb * 1e3:.2f} ms, detect "
            f"{t['detect_s'] / nb * 1e3:.2f} ms")
    if busy is not None:
        # kernel time from the profiled pass, over this (unprofiled) pass's wall time: the
        # profiler's own host work stretches the profiled pass several times over
        line += (f"; device busy {busy[0]:.1f} ms of kernels, {busy[0] / res['seconds'] / 10:.1f}% "
                 f"of this pass's {res['seconds'] * 1e3:.1f} ms (profiled pass {busy[1]:.1f} ms; "
                 "kernel ms: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                          sorted(busy[2].items(), key=lambda kv: -kv[1])) + ")")
    phase(line)


def eval_path(path, argv, by_path):
    """The evaluate CLI over ``argv`` as a counted path: K1 exactly twice per
    detect call (one per batch), a finite mAP (VOC) or AP, AP50 and AP75
    (COCO)."""
    from trcnn_torch.cli import evaluate

    res, launches = count_path(path, by_path, lambda: quiet(evaluate.run, argv))
    nb = sum(res["timing"]["batches"].values())
    if launches["nms"] != 2 * nb:
        raise AssertionError(f"{path}: K1 launched {launches['nms']} times in {nb} detect calls")
    metrics = {k: v for k, v in res["metrics"].items()
               if k in ("eval_mAP", "eval_AP", "eval_AP50", "eval_AP75")}
    if not metrics or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{path}: {metrics}")
    return res


def phase_eval(dev, by_path, npz, tmp):
    """The evaluate CLI on SyntheticDetection(n=64) (h 360-600, w 480-800:
    both canvas buckets, 608x1024 and 1024x608) at batch 8: VGG-16 from the
    exported npz in float32 and bfloat16, ResNet-101 (seeded) on 16 images.
    Per run: a profiled pass (the device's busy share over the evaluation),
    then the counted, timed pass.  Before them, one pass in each dtype
    and one of ResNet-101 record the first call of each kernel input shape
    and replay it through the plain version (K3's f32 and bf16 kernels on
    both canvases, K2 at batch 8 on both maps, every K1 call; the first 16
    images hold one portrait image, so ResNet-101 sees both maps too)."""
    import os

    from trcnn_torch.cli import evaluate

    common = ["--dataset", "synthetic", "--batch_size", "8", "--device", "cuda"]
    vgg = common + ["--pretrained_model", npz]
    r101 = common + ["--backbone", "resnet101", "--limit", "16"]
    img = evaluate.make_config("vgg16").image
    canvases = {(img.pad_h, img.pad_w), (img.pad_w, img.pad_h)}
    for what, argv in (("VGG-16 float32", vgg + ["--dtype", "float32"]),
                       ("VGG-16 bfloat16", vgg + ["--dtype", "bfloat16"]),
                       ("ResNet-101-C4 float32", r101)):
        captured = {}
        with recording(captured, first_of_shape=True):
            quiet(evaluate.run, argv)
        key = "stem" if what.startswith("VGG") else "roi_pool"
        maps = {tuple(a[0].shape[1:3]) for a, _ in captured[key]}
        if key == "roi_pool":
            maps = {(16 * h, 16 * w) for h, w in maps}
        if maps != canvases:
            raise AssertionError(f"the {what} evaluation gave {key} only {maps}")
        replay(captured, f"{what} evaluation (first call of each K2 / K3 shape)")
        del captured

    for dtype in ("float32", "bfloat16"):
        argv = vgg + ["--dtype", dtype, "--write_dets", os.path.join(tmp, f"dets_{dtype}")]
        busy = busy_over(lambda: quiet(evaluate.run, argv))
        res = eval_path(f"vgg16 evaluate {dtype}", argv, by_path)
        if len(res["files"]) != 20 or not all(os.path.exists(f) for f in res["files"]):
            raise AssertionError(f"--write_dets wrote {len(res['files'])} files")
        n_lines = sum(1 for f in res["files"] for _ in open(f))
        print_eval(f"VGG-16 {dtype}, {n_lines} devkit lines in 20 files", res, busy)
        if len(res["timing"]["batches"]) != 2:
            raise AssertionError(f"one canvas bucket only: {res['timing']['batches']}")
    busy = busy_over(lambda: quiet(evaluate.run, r101))
    print_eval("ResNet-101-C4 float32 (seeded)",
               eval_path("resnet101 evaluate", r101, by_path), busy)


def phase_train_cli(dev, by_path, npz, sd, tmp):
    """The train CLI from the exported npz: 4 steps at batch 8 on the
    synthetic set with the evaluator hook at step 4 (16 held-out images);
    trained parameters moved, frozen ones not; the checkpoint read back by
    the evaluate CLI's --checkpoint_dir.  The run records the first call of
    each kernel input shape (K4 on every map its batches give it) and
    replays it through the plain version.  With ``--out`` the CLI makes a
    metric writer under ``<out>/tb`` when tensorboard imports: printed
    either way."""
    import os

    import torch

    from trcnn_torch.cli import evaluate, train
    from trcnn_torch.train.optim import is_frozen

    out = os.path.join(tmp, "train")
    argv = ["--dataset", "synthetic", "--batch_size", "8", "--iters", "4", "--eval_every", "4",
            "--eval_limit", "16", "--log_every", "1", "--out", out, "--pretrained_model", npz,
            "--device", "cuda"]
    captured = {}
    t0 = time.perf_counter()
    with recording(captured, first_of_shape=True):
        trainer, launches = count_path("vgg16 train CLI", by_path,
                                       lambda: quiet(train.run, argv))
    secs = time.perf_counter() - t0
    replay(captured, "f32 train CLI (first call of each kernel input shape)")
    del captured
    nb = sum(trainer.evaluator.timing["batches"].values())
    if trainer.state.step != 4 or launches["nms"] != 4 + 2 * nb:
        raise AssertionError(f"train CLI: step {trainer.state.step}, K1 {launches['nms']}")
    for k, p in trainer.state.model.named_parameters():
        moved = not torch.equal(p.detach().cpu(), sd[k])
        if moved == is_frozen(k):
            raise AssertionError(f"train CLI: {k} {'moved' if moved else 'did not move'}")
    writer = trainer.tcfg.metric_writer
    if writer is None:
        log = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                           "cli.txt")
        said = [x.strip() for x in open(log) if "metric writer" in x]
        writer = f"none made ({said[-1] if said else 'the CLI said nothing'})"
    else:
        writer = f"{type(writer).__name__}, files {sorted(os.listdir(os.path.join(out, 'tb')))}"
    phase(f"train CLI: 4 steps at batch 8 + the eval hook ({nb} batches) in {secs:.1f} s "
          f"(kernel inputs recorded); "
          f"launches {launches}; frozen parameters unchanged, trained ones moved; metric "
          f"writer: {writer}")
    res = eval_path("vgg16 evaluate checkpoint", ["--dataset", "synthetic", "--checkpoint_dir", out,
                                                  "--limit", "16", "--device", "cuda"], by_path)
    trained = trainer.state.model.state_dict()
    if res["checkpoint_step"] != 4 or any(not torch.equal(v, trained[k])
                                          for k, v in res["model"].state_dict().items()):
        raise AssertionError("evaluate --checkpoint_dir did not load the trained model")
    print_eval("evaluate --checkpoint_dir (step 4)", res)
    del trainer


def phase_forward_cli(dev, by_path, npz, tmp):
    """The forward CLI on one image file, if the machine has an image
    library to write and read one."""
    import contextlib
    import io
    import os

    from trcnn_torch.cli import forward
    from trcnn_torch.data import SyntheticDetection
    from trcnn_torch.data.image import image_library, read_image, write_detections

    lib = image_library()
    if lib is None:
        phase("forward CLI: not run: this machine has no image library (cv2 or PIL) to "
              "write or decode an image file")
        return
    img = SyntheticDetection(n=1, seed=5).get_example(0)["image"]
    img_fn, out_fn = os.path.join(tmp, "image.png"), os.path.join(tmp, "result.png")
    write_detections(img, [], [], img_fn)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc, launches = count_path("vgg16 forward CLI", by_path, lambda: forward.main(
            ["--img_fn", img_fn, "--out_fn", out_fn, "--pretrained_model", npz,
             "--score_thresh", "0.0", "--device", "cuda"]))
    lines = text.getvalue().splitlines()
    log_file("forward_cli.txt", text.getvalue())
    if rc != 0 or launches["nms"] != 4 or read_image(out_fn).shape != img.shape:
        raise AssertionError(f"forward CLI: rc {rc}, launches {launches}, output {lines[-1:]}")
    phase(f"forward CLI ({lib}): {lines[0]}; {lines[1]}; wrote {os.path.basename(out_fn)}")


# ---------------------------------------------------------------- the last modules


def phase_convert(npz, tmp):
    """The convert CLI on the full-width VGG-16 npz of :func:`phase_weights`:
    to_flax, to_chainer, to_flax again, the two flax npz bit-equal key for
    key; ``download --file`` on the npz gives the first flax npz.  Host
    work (numpy), no kernel."""
    import os

    from trcnn_torch.cli import convert, download

    flat, back, again, dl = (os.path.join(tmp, f"{n}.npz")
                             for n in ("flax", "chainer_back", "flax_again", "download"))
    t0 = time.perf_counter()
    for argv in (["--src", npz, "--dst", flat, "--direction", "to_flax"],
                 ["--src", flat, "--dst", back, "--direction", "to_chainer"],
                 ["--src", back, "--dst", again, "--direction", "to_flax"]):
        if quiet(convert.main, argv) != 0:
            raise AssertionError(f"convert {argv} failed")
    secs = time.perf_counter() - t0
    if quiet(download.main, ["--file", npz, "--out", dl]) != 0:
        raise AssertionError("download --file failed")
    first = dict(np.load(flat))
    for name, path in (("to_chainer -> to_flax", again), ("download --file", dl)):
        other = dict(np.load(path))
        bad = [k for k in first if k not in other or first[k].dtype != other[k].dtype
               or first[k].tobytes() != other[k].tobytes()]
        if bad or other.keys() != first.keys():
            raise AssertionError(f"convert: {name} differs at {bad[:5]}")
    phase(f"convert CLI: full-width VGG-16 npz -> to_flax ({len(first)} tensors, "
          f"{os.path.getsize(flat) / 2**20:.0f} MiB) -> to_chainer -> to_flax bit-equal, key for "
          f"key ({secs:.1f} s for the three); download --file gives the same flat npz")


def write_voc_set(tmp, n: int):
    """``SyntheticDetection(n)`` as a VOC tree (JPEG files, annotation XML,
    the test split) in ``tmp``, even images landscape and odd ones
    portrait (transposed where needed), so that both canvas buckets are
    used.  Returns the root and the number of images per bucket."""
    import os

    from trcnn_torch.config import VOC_CLASSES
    from trcnn_torch.data import SyntheticDetection
    from trcnn_torch.data.image import image_library, write_detections

    if image_library() is None:
        raise RuntimeError("no image library (cv2 or PIL) to write the VOC set's images")
    root = os.path.join(tmp, "VOC2007")
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d))
    ds = SyntheticDetection(n=n, seed=17)
    ids, buckets = [], {"landscape": 0, "portrait": 0}
    for i in range(n):
        ex = ds.get_example(i)
        img, boxes = ex["image"], ex["boxes"]
        h, w = img.shape[:2]
        if (w >= h) != (i % 2 == 0):
            img, boxes = img.transpose(1, 0, 2).copy(), boxes[:, [1, 0, 3, 2]]
        buckets["landscape" if img.shape[1] >= img.shape[0] else "portrait"] += 1
        iid = f"{i:06d}"
        ids.append(iid)
        write_detections(img, [], [], os.path.join(root, "JPEGImages", f"{iid}.jpg"))
        objs = "".join(
            f"<object><name>{VOC_CLASSES[c]}</name><difficult>0</difficult><bndbox>"
            f"<xmin>{x1 + 1:.0f}</xmin><ymin>{y1 + 1:.0f}</ymin><xmax>{x2 + 1:.0f}</xmax>"
            f"<ymax>{y2 + 1:.0f}</ymax></bndbox></object>"
            for (x1, y1, x2, y2), c in zip(boxes.tolist(), ex["labels"].tolist()))
        with open(os.path.join(root, "Annotations", f"{iid}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{img.shape[1]}</width><height>{img.shape[0]}"
                    f"</height><depth>3</depth></size>{objs}</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return root, buckets


def phase_parity(dev, by_path, npz, tmp):
    """The parity CLI at full width on a VOC tree of 16 synthetic images
    (8 per canvas bucket) read with ``--reference_npz`` from the exported
    npz, float32: run 1 captures 8 goldens at batch 1 and passes
    ``--target_map 0`` (its first kernel call of each input shape replayed
    through the plain versions); run 2 compares them with zero deltas;
    run 3 with ``--target_map 1.0`` prints PARITY FAIL and exits 2.  Each
    run is a counted path, K1 exactly twice per detect call (8 goldens at
    batch 1, one batch of 8 per bucket)."""
    import contextlib
    import io
    import os

    from trcnn_torch.cli import parity

    root, buckets = write_voc_set(tmp, 16)
    if buckets != {"landscape": 8, "portrait": 8}:
        raise AssertionError(f"the VOC set's buckets {buckets}")
    golden = os.path.join(tmp, "parity_goldens.json")
    common = ["--voc_root", root, "--reference_npz", npz, "--golden", golden,
              "--golden_images", "8", "--batch_size", "8", "--device", dev.type]
    calls = 8 + 2
    for run, extra in enumerate((["--target_map", "0"], ["--target_map", "0"],
                                 ["--target_map", "1.0"]), 1):
        path = f"vgg16 parity run {run}"
        text = io.StringIO()
        captured = {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text), recording(captured, first_of_shape=run == 1):
            rep, launches = count_path(path, by_path, lambda: parity.run(common + extra))
        secs = time.perf_counter() - t0
        out = text.getvalue()
        log_file("cli.txt", f"$ trcnn_torch.cli.parity {' '.join(common + extra)}\n{out}")
        if launches["nms"] != 2 * calls:
            raise AssertionError(f"{path}: K1 launched {launches['nms']} times in {calls} "
                                 f"detect calls")
        g = rep["golden"]
        if run == 1:
            replay(captured, "parity run 1 (first call of each kernel input shape)")
            ok = rep["exit"] == 0 and g == {"captured": 8, "path": golden}
        elif run == 2:
            ok = rep["exit"] == 0 and g["ok"] and g["compared"] == 8 and \
                g["max_box_delta"] == 0.0 and g["max_score_delta"] == 0.0
        else:
            ok = rep["exit"] == 2 and "PARITY FAIL" in out and g["ok"]
        del captured
        if not ok or not np.isfinite(rep["mAP"]):
            raise AssertionError(f"{path}: {rep}")
        n_dets = sum(len(v["scores"]) for v in json.load(open(golden)).values())
        phase(f"parity CLI run {run} ({' '.join(extra)}): exit {rep['exit']}, "
              f"mAP {rep['mAP']:.4f} on 16 VOC-layout images (8 per bucket), golden "
              f"{json.dumps(g)} ({n_dets} golden boxes), {secs:.1f} s; launches {launches}")


def phase_train_steps(dev, by_path):
    """``train_steps`` at VGG-16 VOC full width, K=4 at batch 8 (bf16
    compute, float32 master weights): one cold call as a counted path (K1
    exactly 4 times, K1-K4 move; the state's step advances by 4, the last
    metrics finite), then 3 calls in turns with 4 sequential ``train_step``
    calls on the same batches: ms per step each way."""
    import torch

    from trcnn_torch.entry import train_entry
    from trcnn_torch.train.step import BATCH_KEYS, train_step, train_steps

    k = 4
    step_fn, (state, batch) = train_entry(dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    batches = [dict(batch, images=torch.randint(0, 256, batch["images"].shape, dtype=torch.uint8,
                                                generator=gen, device=dev)) for _ in range(k)]
    stacked = {key: torch.stack([b[key] for b in batches]) for key in BATCH_KEYS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, launches = count_path("vgg16 train_steps", by_path, lambda: train_steps(state, stacked))
    cold = (time.perf_counter() - t0) * 1e3
    if launches["nms"] != k or state.step != k:
        raise AssertionError(f"train_steps: K1 {launches['nms']}, step {state.step}")
    vals = check_step(m, k)

    def sequential():
        for b in batches:
            train_step(state, b)

    times = {"train_steps": [], "sequential": []}
    for _ in range(3):
        for name, run in (("train_steps", lambda: train_steps(state, stacked)),
                          ("sequential", sequential)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / k)
    if state.step != 7 * k:
        raise AssertionError(f"train_steps: step {state.step} after 7 calls of {k} steps")
    phase(f"train_steps: VGG-16 VOC b=8, K={k}: cold call {cold:.1f} ms, launches {launches}, "
          f"step 0 -> {k}, last metrics " + ", ".join(f"{n} {x:.5g}" for n, x in vals.items())
          + "; ms per step in turns: train_steps "
          + ", ".join(f"{t:.2f}" for t in times["train_steps"]) + "; sequential train_step "
          + ", ".join(f"{t:.2f}" for t in times["sequential"]))
    del state, batches, stacked
    torch.cuda.empty_cache()


def phase_preprocess_device(dev, by_path):
    """``preprocess_device`` at the VOC canvas on a (1024, 1024, 3) raw
    buffer holding a 375x500 image, then one holding a 500x375 image (the
    portrait bucket's config): the card's canvas within 1e-3 of the port's
    CPU result, im_info equal; both canvases through the detect path
    (seeded VGG-16, bf16) as one counted path, K1 twice per call; ms per
    image on the card beside the host path's (``preprocess_image``), and
    one call's device time by kernel family (``trcnn_torch.utils``'
    ``trace_to`` and ``op_time_breakdown``)."""
    import dataclasses
    import os
    import shutil

    import torch

    from trcnn_torch.data.preprocess import compute_scale, preprocess_device, preprocess_image
    from trcnn_torch.entry import entry
    from trcnn_torch.utils import op_time_breakdown, time_fn, trace_to

    fn, (model, _, _) = entry(dev)
    icfg = model.cfg.image
    rng = np.random.default_rng(29)
    cases = []
    for h, w in ((375, 500), (500, 375)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        raw = np.zeros((1024, 1024, 3), np.uint8)
        raw[:h, :w] = img
        cfg = icfg if w >= h else dataclasses.replace(icfg, pad_h=icfg.pad_w, pad_w=icfg.pad_h)
        scale = compute_scale(h, w, icfg)
        raw_dev = torch.from_numpy(raw).to(dev)
        canvas, info = preprocess_device(raw_dev, h, w, scale, cfg)
        want, want_info = preprocess_device(torch.from_numpy(raw), h, w, scale, cfg)
        err = float((canvas.cpu() - want).abs().max())
        if err > 1e-3 or not torch.equal(info.cpu(), want_info):
            raise AssertionError(f"preprocess_device {h}x{w}: card vs CPU {err}, im_info "
                                 f"{info.tolist()} vs {want_info.tolist()}")
        ms, _ = time_fn(preprocess_device, raw_dev, h, w, scale, cfg)
        host, _ = time_fn(preprocess_image, img, icfg)
        cases.append((f"{h}x{w}", canvas, info, err, ms * 1e3, host * 1e3))

    def detect_both():
        out = []
        for _, canvas, info, *_ in cases:
            dets = fn(model, canvas[None], info[None])
            check_dets(dets, 1)
            out.append(dets)
        return out

    # one traced call (trcnn_torch.utils.trace_to): its device time by kernel family
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                             "trace_preprocess_device")
    shutil.rmtree(trace_dir, ignore_errors=True)
    raw_dev = torch.from_numpy(raw).to(dev)
    with trace_to(trace_dir):
        preprocess_device(raw_dev, h, w, scale, cfg)
    split = op_time_breakdown(trace_dir)
    if not split:
        raise AssertionError("preprocess_device's trace shows no device time")
    _, launches = count_path("vgg16 preprocess_device detect", by_path, detect_both)
    if launches["nms"] != 2 * len(cases):
        raise AssertionError(f"preprocess_device detect: K1 {launches['nms']} in "
                             f"{len(cases)} calls")
    phase("preprocess_device: " + "; ".join(
        f"{what} in a 1024x1024 buffer -> canvas {tuple(c.shape)}, im_info "
        f"{[round(x, 4) for x in i.tolist()]}, card vs CPU {e:.2e}, {ms:.3f} ms on the card "
        f"against {host:.2f} ms for the host path (numpy)" for what, c, i, e, ms, host in cases)
        + f"; both through detect: launches {launches}; the 500x375 call's device ms by "
        f"kernel family (op_time_breakdown of a trace_to trace): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    del model, cases
    torch.cuda.empty_cache()


def phase_large_map(dev, by_path):
    """One VGG-16 train step at batch 1 on a 4800 x 1440 canvas: its 300 x
    90 map takes K4's large-map variant on the main path.  Its kernel calls
    are recorded and replayed through the plain versions (K4's large-map
    variant within one bf16 ulp of the largest |dfeat|)."""
    import dataclasses

    import torch

    from trcnn_torch.config import voc_config
    from trcnn_torch.entry import train_entry

    cfg = voc_config()
    cfg = cfg.replace(image=dataclasses.replace(cfg.image, pad_h=4800, pad_w=1440))
    step_fn, (state, batch) = train_entry(dev, cfg=cfg, batch_size=1)
    captured = {}
    with recording(captured):
        m, launches = count_path("vgg16 train 4800x1440", by_path, lambda: step_fn(state, batch))
    vals = check_step(m, 0)
    if [tuple(a[0].shape[1:3]) for a, _ in captured["roi_pool_bwd"]] != [(300, 90)]:
        raise AssertionError("the 4800x1440 step did not give K4 one 300x90 map")
    replay(captured, "bf16 train step on a 4800x1440 canvas")
    del captured
    phase(f"train step on a 4800x1440 canvas (300x90 map): launches {launches}; "
          f"loss {vals['loss']:.5g}, grad_norm {vals['grad_norm']:.5g}")
    del state, batch
    torch.cuda.empty_cache()


def autograd_frozen_bn(self, x):
    """FrozenBatchNorm's forward as plain autograd ops (the fold, the casts,
    the multiply and the add each a node), its design before the written-out
    backward: the same values, for the R1 turns only."""
    import torch

    inv = self.scale / torch.sqrt(self.var + self.eps)
    shift = self.bias - self.mean * inv
    return x * inv.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


def phase_r1_cost(dev):
    """The ResNet-101 train step at batch 8 with the res3-res5 FrozenBN
    leaves' gradients through FrozenBatchNorm's written-out backward (this
    tree), through plain autograd ops (``autograd_frozen_bn``), and without
    them (the leaves set to take none, as before R1), in turns: without,
    written-out, autograd, autograd, written-out, without; 4 steps each."""
    import torch

    from trcnn_torch.entry import train_entry
    from trcnn_torch.models import resnet
    from trcnn_torch.train.optim import is_frozen

    step_fn, (state, batch) = train_entry(dev, backbone="resnet101")
    leaves = [p for k, p in state.model.named_parameters()
              if is_frozen(k, "resnet101") and "bn" in k
              and not k.startswith(("extractor.bn1", "extractor.res2"))]
    step_fn(state, batch)
    written_out = resnet.FrozenBatchNorm.forward
    arms = {"without": (False, written_out), "written-out": (True, written_out),
            "autograd": (True, autograd_frozen_bn)}
    ms = {arm: [] for arm in arms}
    try:
        for arm in ("without", "written-out", "autograd", "autograd", "written-out", "without"):
            with_grads, forward = arms[arm]
            resnet.FrozenBatchNorm.forward = forward
            for p in leaves:
                p.requires_grad_(with_grads)
            times = []
            for _ in range(4):
                t0 = time.perf_counter()
                step_fn(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[arm].append(statistics.median(times))
    finally:
        resnet.FrozenBatchNorm.forward = written_out
    phase(f"R1: ResNet-101 train step b=8, median ms in turns, the {len(leaves)} FrozenBN "
          f"leaves' gradients through the written-out backward "
          f"{', '.join(f'{t:.2f}' for t in ms['written-out'])}; through autograd's ops "
          f"{', '.join(f'{t:.2f}' for t in ms['autograd'])}; without them "
          f"{', '.join(f'{t:.2f}' for t in ms['without'])}")
    del state, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- COCO

COCO_MAP = (50, 84)      # the 800 x 1344 canvas at stride 16
# COCO's 80 category ids, sparse in 1..90
COCO_CATEGORY_IDS = tuple(i for i in range(1, 91)
                          if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))


def coco_cfg(backbone: str = "vgg16", mode: str = "max"):
    from trcnn_torch.config import coco_config

    return with_mode(coco_config().replace(backbone=backbone), mode)


def host_ms(fn, n: int = 5) -> float:
    """Median host-clock ms of ``n`` calls of ``fn``, each ended by a
    synchronize, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def coco_epilogue_raw(b: int, r: int, seed: int, dev):
    """The COCO epilogue's input at uniform scores (``epilogue_case``'s, at
    81 classes): per image ``r`` RoIs clustered like proposals on the
    796 x 1340 image (``nms_case``, 3% invalid), each class's box its RoI
    moved by normalised deltas N(0, 1) (0.1-0.2 of the box), class
    probabilities uniform in [0, 1] in hundredths, so that about 95% of the
    80 x r (class, RoI) pairs clear the 0.05 threshold; image 1 has no valid
    RoI, image 2 only its first 40."""
    import torch

    from trcnn_torch.models.faster_rcnn import RawDetections

    rng = np.random.default_rng(seed)
    cases = [nms_case(r, seed + i, im=(796.0, 1340.0)) for i in range(b)]
    rois = np.stack([c[0] for c in cases])
    valid = np.stack([c[2] for c in cases])
    valid[1] = False
    valid[2, 40:] = False
    prob = np.round(rng.uniform(0, 1, (b, r, 81)), 2).astype(np.float32)
    deltas = rng.standard_normal((b, r, 4 * 81)).astype(np.float32)
    raw = RawDetections(*(torch.from_numpy(a).to(dev) for a in (rois, valid, prob, deltas)))
    return raw, torch.tensor([[796.0, 1340.0, 1.0]] * b, device=dev)


def epilogue_report(raw, im_info, cfg, what, rec):
    """The test-time epilogue (``postprocess``) on ``raw``: K1 on the
    batch's valid prefix of the score-sorted (class, RoI) pairs (the port),
    and for comparison on all of them (``nms.valid_prefix`` patched to the
    full width).  Both epilogues' detections must be equal and the trimmed
    K1 call equal to its plain version.  Prints and records the valid
    counts, the mask bytes, K1's time on each input and each epilogue's
    (host clock around a synchronize: the trim reads one count back)."""
    import torch

    from trcnn_torch.models import postprocess
    from trcnn_torch.ops import nms

    real = nms.valid_prefix
    arms = {}
    for arm, prefix in (("trimmed", real), ("untrimmed", lambda sv: sv.shape[-1])):
        nms.valid_prefix = prefix
        try:
            captured = {}
            with recording(captured):
                dets = postprocess(raw, im_info, cfg)
                torch.cuda.synchronize()
            (args, out), = captured["nms"]
            k1 = cuda_time_ms(lambda: nms.greedy_keep_cuda(*args), warmup=1, iters=5)
            ms = host_ms(lambda: postprocess(raw, im_info, cfg))
        finally:
            nms.valid_prefix = real
        b, n = args[1].shape
        arms[arm] = dict(dets=dets, args=args, out=out, k1=k1, ms=ms, n=n,
                         mask=b * n * -(-n // 64) * 8)
        del captured
    t, u = arms["trimmed"], arms["untrimmed"]
    if not all(torch.equal(x, y) for x, y in zip(t["dets"], u["dets"])):
        raise AssertionError(f"epilogue {what}: the trimmed K1 input changed the detections")
    args, (kp, kv) = t["args"], t["out"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp, pv = nms.greedy_keep_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(kp, pp) and torch.equal(kv, pv)):
        raise AssertionError(f"K1 differs from plain on the epilogue's inputs: {what}")
    del pp, pv
    counts = args[1].sum(-1).tolist()
    pairs, bd = nms_bound((args[0], args[1], args[4]), args[2], args[3])
    shape = f"epilogue ({b},{u['n']})->{args[3]} @{args[2]} {what}"
    phase(f"  K1 {shape}: valid pairs per image {counts}; K1 on the first {t['n']} sorted "
          f"pairs, mask {t['mask'] / 2**20:.2f} MiB ({u['mask'] / 2**20:.2f} MiB on all "
          f"{u['n']}); K1 {t['k1']:.4f} ms ({u['k1']:.4f} untrimmed), plain {plain_ms:.1f} ms, "
          f"bound {bd['bound_ms']:.4f} ms ({pairs} predicates); epilogue {t['ms']:.3f} ms "
          f"({u['ms']:.3f} untrimmed); detections equal with and without the trim, keep-sets "
          f"equal to the plain version's")
    rec["nms"]["shapes"].append(dict(
        shape=shape, ms=t["k1"], plain_ms=plain_ms, untrimmed_ms=u["k1"], valid_per_image=counts,
        width=t["n"], mask_bytes=t["mask"], untrimmed_mask_bytes=u["mask"],
        epilogue_ms=t["ms"], untrimmed_epilogue_ms=u["ms"], **bd))
    del arms, t, u
    torch.cuda.empty_cache()


def per_class_row(raw, im_info, cfg, rec):
    """multiclass_nms's per-class path (50 per class, 100 in all) on the
    COCO epilogue: its one K1 launch takes the B x 80 (image, class) rows;
    the call replayed through the plain version and timed."""
    import dataclasses

    import torch

    from trcnn_torch.models import postprocess
    from trcnn_torch.ops import nms

    cfg = cfg.replace(test=dataclasses.replace(cfg.test, max_dets_per_class=50))
    captured = {}
    with recording(captured):
        dets = postprocess(raw, im_info, cfg)
        torch.cuda.synchronize()
    check_dets(dets, raw.rois.shape[0])
    (args, _), = captured["nms"]
    what = f"per-class epilogue, K1 batch {tuple(args[1].shape)} -> {args[3]}"
    replay(captured, what)
    ms = cuda_time_ms(lambda: nms.greedy_keep_cuda(*args), warmup=1, iters=5)
    pairs, bd = nms_bound((args[0], args[1], args[4]), args[2], args[3])
    phase(f"  K1 time at the {what}: {ms:.4f} ms, bound {bd['bound_ms']:.4f} ms")
    rec["nms"]["shapes"].append(dict(shape=what, ms=ms, **bd))
    del captured


def phase_coco_kernels(dev, rec):
    """Each kernel at the COCO config's shapes against its plain version,
    timed beside its bound: K1 on the COCO epilogue at uniform scores
    (:func:`epilogue_report`) and at the per-class launch shape; K2 at
    (8, 1000) RoIs and K4 at (8, 128) on the 50 x 84 map, P=7 C=512 and
    P=14 C=1024, bf16 and f32 (bit-equal, K4 on integer g, at B=2); K3 on
    the 800 x 1344 canvas and its portrait transpose (bit-equal on integer
    inputs, within tolerance on real ones, at B=2), timed at B=8 beside the
    cuDNN composite."""
    import torch

    from trcnn_torch.ops import roi_pool

    phase("COCO shapes, kernels vs plain versions:")
    cfg = coco_cfg()
    raw, info = coco_epilogue_raw(8, 1000, 60, dev)
    epilogue_report(raw, info, cfg, "uniform scores", rec)
    per_class_row(raw, info, cfg, rec)
    del raw
    torch.cuda.empty_cache()

    fh, fw = COCO_MAP
    gen = torch.Generator(device=dev).manual_seed(66)
    for p, c in ((7, 512), (14, 1024)):
        feat, rois = roi_case(2, 1000 if p == 7 else 300, 61 + p, fh=fh, fw=fw, c=c)
        rois_t = torch.from_numpy(rois).to(dev)
        rois128 = rois_t[:, :128].contiguous()
        g_int = torch.from_numpy(np.random.default_rng(62 + p).integers(
            -4, 5, tuple(rois128.shape[:2]) + (p, p, feat.shape[-1])).astype(np.float32))
        for dt in (torch.bfloat16, torch.float32):
            feat_t = torch.from_numpy(feat).to(dev, dt)
            rec["roi_pool"]["max_abs_err"] = max(rec["roi_pool"]["max_abs_err"], check_roi_equal(
                feat_t, rois_t, f"COCO map B=2x{rois.shape[1]} P={p} C={c} {dt}", p))
            rec["roi_pool_bwd"]["max_abs_err"] = max(
                rec["roi_pool_bwd"]["max_abs_err"],
                check_roi_bwd(feat_t, rois128, g_int.to(dev, dt),
                              f"COCO map B=2x128 P={p} C={c} {dt} integer g", True))
        del feat_t, g_int
        feat, rois = roi_case(8, 1000, 63 + p, fh=fh, fw=fw, c=c)
        rois_t = torch.from_numpy(rois).to(dev)
        rois128 = rois_t[:, :128].contiguous()
        for dt in (torch.bfloat16, torch.float32):
            feat_t = torch.from_numpy(feat).to(dev, dt)
            name = str(dt).split(".")[-1]
            rec["roi_pool"]["shapes"].append(roi_row(
                "K2", f"(8,1000) P={p} C={c} {name}, COCO 50x84 map", feat_t, rois_t, out_size=p,
                plain_iters=1))
            torch.cuda.empty_cache()
            plan = roi_pool._bwd_plan(fh, fw, feat_t.element_size())
            g = torch.randn(tuple(rois128.shape[:2]) + (p, p, feat.shape[-1]), generator=gen,
                            device=dev).to(dt)
            rec["roi_pool_bwd"]["shapes"].append(roi_row(
                "K4", f"(8,128) P={p} C={c} {name}, COCO 50x84 map, cc={plan.cc}", feat_t,
                rois128, g, p, plain_iters=1))
            del feat_t, g
            torch.cuda.empty_cache()

    for integer in (True, False):
        kind = "integer" if integer else "real"
        for shape in ((2, 800, 1344, 3), (2, 1344, 800, 3)):
            case = stem_case(shape, 64, integer=integer)
            for dt in (torch.float32, torch.bfloat16) if integer else (torch.bfloat16,):
                args = [torch.from_numpy(a).to(dev, dt) for a in case]
                rec["stem"]["max_abs_err"] = max(rec["stem"]["max_abs_err"], check_stem(
                    args, f"{shape} {dt} {kind} (COCO)", exact=integer))
    for what, shape in (("(8,800,1344,3) bf16 (COCO)", (8, 800, 1344, 3)),
                        ("(8,1344,800,3) bf16 (COCO portrait)", (8, 1344, 800, 3))):
        args = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in stem_case(shape, 65)]
        rec["stem"]["shapes"].append(stem_row(what, args))
    del args
    torch.cuda.empty_cache()


def phase_coco_detect(dev, backbone: str, rec, mode: str = "max"):
    """The COCO detect path through ``entry(cfg=coco_config())``: seeded
    weights calibrated (:func:`calibrate`) so that the 81-way epilogue
    keeps detections, a one-image request and a batch of 8 uint8
    (800, 1344) canvases in bf16, the launch counts (K1 exactly twice per
    call), latencies, the profile and peak memory; then one call with the
    first kernel call of each input shape (every K1 call) recorded and
    replayed through the plain versions, and the epilogue report on this
    model's own batch (:func:`epilogue_report`).  ``mode="align"``:
    RoIAlign, and K5 checked and timed on the batch's own inputs
    (:func:`path_align_rows`) instead of the epilogue report."""
    import torch

    from trcnn_torch import _build
    from trcnn_torch.entry import entry

    cfg = coco_cfg(backbone, mode)
    t0 = time.perf_counter()
    fn, (model, image, im_info) = entry(dev, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(8)
    images8 = torch.randint(0, 256, (8,) + image.shape[1:], dtype=torch.uint8, generator=gen,
                            device=dev)
    im_info8 = im_info.expand(8, 3).contiguous()
    calibrate(model, images8[:2], im_info8[:2], head=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase(f"COCO detect: {NAMES[backbone]} bf16, 81 classes, uint8 {tuple(image.shape[1:3])}, "
          f"{cfg.proposals.post_nms_topk_test} proposals, RoI {mode} {model.pool_size}, built "
          f"and calibrated in {time.perf_counter() - t0:.1f} s")

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    dets = fn(model, image, im_info)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    check_dets(dets, 1)
    dets8 = fn(model, images8, im_info8)
    torch.cuda.synchronize()
    check_dets(dets8, 8)
    launches = dict(_build.launch_counts)
    phase(f"  launches over one request + one batch of 8: {launches}; detections per image "
          f"{dets8.valid.sum(-1).tolist()}, classes {len(set(dets8.classes[dets8.valid].tolist()))}")
    require_launches(path_name(backbone, "detect", mode, coco=True), launches)
    require_nms_launches("COCO detect b=8", lambda: fn(model, images8, im_info8), 2)
    warm = host_ms(lambda: fn(model, image, im_info), 3)
    b8 = host_ms(lambda: fn(model, images8, im_info8), 3)
    phase(f"  request latency cold {cold:.2f} ms, warm median {warm:.2f} ms; b=8: {b8:.2f} ms "
          f"per batch, {8e3 / b8:.2f} img/s")
    profile_window(lambda: fn(model, images8, im_info8), 2, "COCO detect b=8")
    phase(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    captured = {}
    with recording(captured, first_of_shape=True):
        fn(model, images8, im_info8)
        torch.cuda.synchronize()
    replay(captured, f"bf16 {NAMES[backbone]} COCO {mode} detect b=8")
    del captured
    torch.cuda.empty_cache()
    if mode == "align":
        path_align_rows(rec, lambda: fn(model, images8, im_info8),
                        f"{NAMES[backbone]} COCO align detect b=8")
        del model
        torch.cuda.empty_cache()
        return launches
    with torch.inference_mode():
        raw = model.detect(images8, im_info8)
    epilogue_report(raw, im_info8, cfg, f"{NAMES[backbone]} calibrated", rec)
    del model, raw
    torch.cuda.empty_cache()
    return launches


def phase_coco_train(dev, backbone: str, rec, mode: str = "max"):
    """The COCO training step through ``train_entry(cfg=coco_config())`` on
    the loader's batches: ``SyntheticDetection`` (81 classes) at batch 8,
    multi-scale shorter sides drawn per image, uint8 canvases; one cold
    step and 4 timed ones; the parameters move after the first, the frozen
    ones never; K1 exactly once per step; the profile split and peak
    memory; then one step with the first kernel call of each input shape
    recorded and replayed through the plain versions.  ``mode="align"``:
    RoIAlign, and K5 and K6 checked and timed on one step's own inputs
    (:func:`path_align_rows`)."""
    import torch

    from trcnn_torch import _build
    from trcnn_torch.data import DetectionLoader, SyntheticDetection
    from trcnn_torch.entry import train_entry
    from trcnn_torch.train.optim import is_frozen
    from trcnn_torch.train.step import STAGES
    from trcnn_torch.train.step import device_batch

    cfg = coco_cfg(backbone, mode)
    t0 = time.perf_counter()
    step_fn, (state, _) = train_entry(dev, cfg=cfg)
    loader = DetectionLoader(SyntheticDetection(n=40, num_classes=cfg.num_classes, seed=5),
                             batch_size=8, image_cfg=cfg.image, augment=True, shuffle=True,
                             seed=1, uint8_images=True)
    batches = [device_batch(b, dev) for b in loader]
    model = state.model
    torch.cuda.synchronize()
    canvases = sorted({tuple(b["images"].shape[1:3]) for b in batches})
    scales = sorted({round(float(s), 4) for b in batches for s in b["im_info"][:, 2].tolist()})
    phase(f"COCO train: {NAMES[backbone]} RoI {mode}, bf16 compute, f32 master weights, "
          f"{len(batches)} loader "
          f"batches of 8, canvases {canvases}, {len(scales)} image scales {scales[0]}-{scales[-1]}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times = []
    for i, batch in enumerate(batches[:5]):
        t0 = time.perf_counter()
        m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check_step(m, i)
        if i == 0:
            for k, p in model.named_parameters():
                moved = not torch.equal(p.detach(), before[k])
                if moved == is_frozen(k, backbone):
                    raise AssertionError(f"after step 1, {k} {'moved' if moved else 'did not move'}")
    launches = dict(_build.launch_counts)
    frozen = [k for k, p in model.named_parameters() if is_frozen(k, backbone)]
    if any(not torch.equal(model.get_parameter(k), before[k]) for k in frozen):
        raise AssertionError("a frozen parameter moved")
    del before
    phase(f"  launches over {len(times)} train steps: {launches}; {len(frozen)} frozen parameters "
          f"unchanged")
    require_launches(path_name(backbone, "train", mode, coco=True), launches)
    require_nms_launches("COCO train step b=8", lambda: step_fn(state, batches[0]), 1)
    warm = statistics.median(times[1:])
    phase(f"  step ms: cold {times[0]:.2f}, warm {', '.join(f'{t:.2f}' for t in times[1:])}; "
          f"median {warm:.2f} ms, {8 / warm * 1e3:.2f} img/s")
    phase(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_window(lambda: step_fn(state, batches[1]), 2, "COCO train step b=8", STAGES)
    captured = {}
    with recording(captured, first_of_shape=True):
        for batch in batches:
            step_fn(state, batch)
        torch.cuda.synchronize()
    replay(captured, f"bf16 {NAMES[backbone]} COCO {mode} train steps (first call of each "
                     f"kernel input shape)")
    del captured
    torch.cuda.empty_cache()
    if mode == "align":
        path_align_rows(rec, lambda: step_fn(state, batches[2]),
                        f"{NAMES[backbone]} COCO align train b=8")
    del model, state, batches
    torch.cuda.empty_cache()
    return launches


def write_coco_set(tmp, n: int):
    """``SyntheticDetection(n, 81 classes)`` as a COCO tree in ``tmp``: PNG
    files and an instances json with COCO's 80 sparse category ids, every
    fourth box a crowd region.  Returns (image dir, json path)."""
    import os

    from trcnn_torch.data import SyntheticDetection
    from trcnn_torch.data.image import image_library, write_detections

    if image_library() is None:
        raise RuntimeError("no image library (cv2 or PIL) to write the COCO set's images")
    ds = SyntheticDetection(n=n, num_classes=len(COCO_CATEGORY_IDS) + 1)
    img_dir = os.path.join(tmp, "coco", "images")
    os.makedirs(img_dir)
    images, anns = [], []
    for i in range(n):
        ex = ds.get_example(i)
        name = f"{i:012d}.png"
        write_detections(ex["image"], [], [], os.path.join(img_dir, name))
        h, w = ex["image"].shape[:2]
        images.append({"id": 100 + i, "file_name": name, "height": h, "width": w})
        for (x1, y1, x2, y2), label in zip(ex["boxes"].tolist(), ex["labels"].tolist()):
            bw, bh = x2 - x1 + 1.0, y2 - y1 + 1.0
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": COCO_CATEGORY_IDS[label - 1], "bbox": [x1, y1, bw, bh],
                         "iscrowd": int(len(anns) % 4 == 3), "area": bw * bh})
    ann_file = os.path.join(tmp, "coco", "instances.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": f"category_{c}"} for c in COCO_CATEGORY_IDS]},
                  f)
    return img_dir, ann_file, sum(a["iscrowd"] for a in anns)


def coco_weights(dev, tmp, img_dir, ann_file):
    """A seeded 81-class VGG-16, calibrated (:func:`calibrate`) on the COCO
    set's first two canvases so that many (class, RoI) pairs clear the
    score threshold, exported to a Chainer npz."""
    import os

    import torch

    from trcnn_torch.convert_chainer import export_chainer_npz
    from trcnn_torch.data import COCODetection, DetectionLoader, upload
    from trcnn_torch.models import make_model

    cfg = coco_cfg()
    model = make_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(12))
    batch = next(iter(DetectionLoader(COCODetection(img_dir, ann_file), batch_size=2,
                                      image_cfg=cfg.image, prefetch=0)))
    calibrate(model, upload(batch.images, dev), upload(batch.im_info, dev), head=True)
    path = os.path.join(tmp, "VGG16_coco_seeded.npz")
    export_chainer_npz({k: v.detach().cpu() for k, v in model.state_dict().items()}, path, cfg)
    del model
    torch.cuda.empty_cache()
    return path


def phase_coco_eval(dev, by_path, tmp):
    """The evaluate CLI with ``--dataset coco`` on 16 synthetic images
    (both canvas buckets, 800x1344 and 1344x800) written as a COCO tree
    with crowd regions, from a seeded calibrated 81-class VGG-16 npz, at
    batch 8 in float32 and bfloat16: per dtype one pass with the first call
    of each kernel input shape (every K1 call) recorded and replayed through
    the plain versions, one profiled pass, and the counted, timed pass
    (K1 twice per detect call; finite AP, AP50 and AP75)."""
    from trcnn_torch.cli import evaluate

    img_dir, ann_file, n_crowd = write_coco_set(tmp, 16)
    npz = coco_weights(dev, tmp, img_dir, ann_file)
    img = coco_cfg().image
    canvases = {(img.pad_h, img.pad_w), (img.pad_w, img.pad_h)}
    phase(f"COCO evaluate CLI: 16 images, {n_crowd} crowd boxes, 80 sparse category ids, seeded "
          f"calibrated 81-class VGG-16")
    for dtype in ("float32", "bfloat16"):
        argv = ["--dataset", "coco", "--dataset_root", img_dir, "--ann_file", ann_file,
                "--pretrained_model", npz, "--batch_size", "8", "--dtype", dtype,
                "--device", dev.type]
        captured = {}
        with recording(captured, first_of_shape=True):
            quiet(evaluate.run, argv)
        maps = {tuple(a[0].shape[1:3]) for a, _ in captured["stem"]}
        if maps != canvases:
            raise AssertionError(f"the COCO {dtype} evaluation gave K3 only {maps}")
        widths = [(int(a[1].sum(-1).max()), a[1].shape[1]) for a, _ in captured["nms"]
                  if a[4] is not None]
        phase(f"  {dtype}: epilogue K1 calls (largest valid count, width after the trim): "
              f"{widths}")
        replay(captured, f"COCO {dtype} evaluation (first call of each K2 / K3 shape)")
        del captured
        busy = busy_over(lambda: quiet(evaluate.run, argv))
        print_eval(f"COCO VGG-16 {dtype}",
                   eval_path(f"vgg16 coco evaluate {dtype}", argv, by_path), busy)



# ---------------------------------------------------------------- RoIAlign and int8


def align_case(b: int, r: int, seed: int, fh=38, fw=64, c=512):
    """:func:`roi_case`'s RoIs (beyond the map: every sample clipped to
    its last cell; partly outside; one cell, which ``max(., 1)`` widens to
    a whole cell) plus a RoI under one cell (half a cell wide, a quarter
    high)."""
    feat, rois = roi_case(b, r, seed, fh, fw, c)
    rois[:, 5] = (101, 203, 109, 207)
    return feat, rois


def check_align(feat, rois, what, out_size=7, out_dtype=None):
    """K5 against its plain version: bit-equal (the same float32 operations
    in the same order, none contracted), with float32 output and with
    bfloat16 output (the float32 mean rounded once: the plain version's
    float32 result cast to bfloat16), or only in ``out_dtype``."""
    import torch

    from trcnn_torch.ops import roi_align

    ref = roi_align.roi_align_plain(feat, rois, out_size)
    err = 0.0
    for od in (torch.float32, torch.bfloat16) if out_dtype is None else (out_dtype,):
        k = roi_align.roi_align_cuda(feat, rois, out_size, out_dtype=od)
        if not torch.equal(bits(k), bits(ref.to(od))):
            raise AssertionError(f"K5 ({str(od)[6:]} output) is not bit-equal to the plain "
                                 f"version: {what}, max abs err "
                                 f"{float((k.float() - ref).abs().max()):.3e}")
        err = max(err, float((k.float() - ref.to(od).float()).abs().max()))
        del k
    outs = "float32 and bfloat16" if out_dtype is None else str(out_dtype)[6:]
    phase(f"  K5 {what}: bit-equal ({outs} output)")
    return err


def check_align_bwd(feat, rois, g, what):
    """K6 against its plain version (:func:`bwd_limit`: K6 merges a bin's
    samples per cell and sums in its own order), for g as given and
    rounded to bfloat16; two calls on the same inputs must be bit-identical
    (each dfeat element is summed by one thread in a fixed order)."""
    import torch

    from trcnn_torch.ops import roi_align

    p_ = g.shape[2]
    worst = 0.0
    for gd in dict.fromkeys((g.dtype, torch.bfloat16)):
        gg = g.to(gd)
        k = roi_align.roi_align_backward_cuda(feat.shape, feat.dtype, rois, gg, p_)
        k2 = roi_align.roi_align_backward_cuda(feat.shape, feat.dtype, rois, gg, p_)
        p = roi_align.roi_align_backward_plain(feat.shape, feat.dtype, rois, gg, p_)
        err = float((k.float() - p.float()).abs().max())
        limit = bwd_limit(p)
        same = torch.equal(bits(k), bits(k2))
        phase(f"  K6 {what}, g {str(gd)[6:]}: max abs err {err:.3e} (limit {limit:.3e} at scale "
              f"{float(p.float().abs().max()):.3e}); two calls bit-identical: {same}")
        if err > limit or not same:
            raise AssertionError(f"K6 disagrees with the plain version or with itself: {what}")
        worst = max(worst, err)
        del k, k2, p
    return worst


def yardstick_grid(rois, out_size, h, w, spatial_scale=1.0 / 16.0, sampling_ratio=2):
    """The sample coordinates of the RoIs (B, R, 4) normalised for
    ``F.grid_sample(align_corners=True)``: (B, R * P*s, P*s, 2), x then y."""
    import torch

    from trcnn_torch.ops.boxes import ieee_div

    b, r = rois.shape[:2]
    ps = out_size * sampling_ratio
    x1, y1, x2, y2 = (rois[..., i] * spatial_scale for i in range(4))
    bin_w = ieee_div(torch.clamp(x2 - x1, min=1.0), float(out_size))
    bin_h = ieee_div(torch.clamp(y2 - y1, min=1.0), float(out_size))
    grid = ieee_div(torch.arange(ps, device=rois.device, dtype=torch.float32) + 0.5,
                    float(sampling_ratio))
    sx = (x1[..., None] + grid * bin_w[..., None]) * (2.0 / (w - 1)) - 1.0
    sy = (y1[..., None] + grid * bin_h[..., None]) * (2.0 / (h - 1)) - 1.0
    return torch.stack([sx[:, :, None, :].expand(b, r, ps, ps),
                        sy[:, :, :, None].expand(b, r, ps, ps)], -1).reshape(b, r * ps, ps, 2)


def yardstick(feat, rois, out_size, g=None, sampling_ratio=2, chunk=None):
    """The library yardstick of K5 (g None) or K6: ``F.grid_sample``
    (bilinear, ``padding_mode="border"``, ``align_corners=True``: the same
    clipped bilinear samples) then ``F.avg_pool2d(s)``, on NCHW views of
    feat; the backward is autograd's through both.  Returns its time (CUDA
    events over back-to-back calls, summed over chunks of ``chunk`` RoIs
    where given) and its largest difference from the plain version."""
    import torch
    import torch.nn.functional as F

    from trcnn_torch.ops import roi_align

    b, h, w, c = feat.shape
    r, s = rois.shape[1], sampling_ratio
    chunk = chunk or r
    x = feat.permute(0, 3, 1, 2)
    ms, err = 0.0, 0.0
    for i in range(0, r, chunk):
        rc = rois[:, i:i + chunk]
        grid = yardstick_grid(rc, out_size, h, w, sampling_ratio=s).to(feat.dtype)

        def fwd(xx):
            return F.avg_pool2d(F.grid_sample(xx, grid, mode="bilinear", padding_mode="border",
                                              align_corners=True), s)

        if g is None:
            ms += cuda_time_ms(lambda: fwd(x), warmup=1, iters=3)
            y = fwd(x).reshape(b, c, rc.shape[1], out_size, out_size).permute(0, 2, 3, 4, 1)
            err = max(err, float((y.float() - roi_align.roi_align_plain(feat, rc, out_size))
                                 .abs().max()))
        else:
            gc = g[:, i:i + chunk]
            gy = gc.permute(0, 4, 1, 2, 3).reshape(b, c, -1, out_size)
            xx = x.detach().requires_grad_()
            y = fwd(xx)
            ms += cuda_time_ms(lambda: torch.autograd.grad(y, xx, gy, retain_graph=True),
                               warmup=1, iters=3)
        del grid, y
        torch.cuda.empty_cache()
    if g is not None:
        xx = x.detach().requires_grad_()
        for i in range(0, r, chunk):
            grid = yardstick_grid(rois[:, i:i + chunk], out_size, h, w,
                                  sampling_ratio=s).to(feat.dtype)
            gy = g[:, i:i + chunk].permute(0, 4, 1, 2, 3).reshape(b, c, -1, out_size)
            F.avg_pool2d(F.grid_sample(xx, grid, mode="bilinear", padding_mode="border",
                                       align_corners=True), s).backward(gy.to(feat.dtype))
        want = roi_align.roi_align_backward_plain(feat.shape, feat.dtype, rois, g, out_size)
        err = float((xx.grad.permute(0, 2, 3, 1).float() - want.float()).abs().max())
        del xx
        torch.cuda.empty_cache()
    return ms, err


def align_row(kernel, what, feat, rois, g=None, out_size=7, plain_iters=1, out_dtype=None,
              library=False, chunk=None):
    """K5 (g None; output in ``out_dtype``, feat's dtype by default) or K6
    at one shape: the kernel's time, its share of the bound, the plain
    version's time, the bound from this run's inputs and, with
    ``library``, the yardstick's time and largest difference (:func:`yardstick`).
    Bytes: inputs read once, the output written once (K5 in its output
    dtype, K6 in feat's).  Operations: per sample, channel and corner a
    product of two weights and an add (3), per bin the mean (1 per
    channel): K5 reads and K6 writes 4 s^2 corners per bin, s = 2."""
    import torch

    from trcnn_torch.ops import roi_align

    b, h, w, c = feat.shape
    r = rois.shape[1]
    bins = b * r * out_size * out_size
    ops = bins * c * (3.0 * 4 * 4 + 1)
    wu = int(plain_iters > 1)
    lib_ms = lib_err = None
    if g is None:
        od = out_dtype or feat.dtype
        ms = cuda_time_ms(lambda: roi_align.roi_align_cuda(feat, rois, out_size, out_dtype=od))
        plain_ms = cuda_time_ms(lambda: roi_align.roi_align_plain(feat, rois, out_size,
                                                                  out_dtype=od),
                                warmup=wu, iters=plain_iters)
        bd = bound(nbytes(feat, rois) + bins * c * torch.empty((), dtype=od).element_size(),
                   ops, F32_OPS)
        if library:
            lib_ms, lib_err = yardstick(feat, rois, out_size, chunk=chunk)
    else:
        ms = cuda_time_ms(lambda: roi_align.roi_align_backward_cuda(
            feat.shape, feat.dtype, rois, g, out_size))
        plain_ms = cuda_time_ms(lambda: roi_align.roi_align_backward_plain(
            feat.shape, feat.dtype, rois, g, out_size), warmup=wu, iters=plain_iters)
        bd = bound(nbytes(rois, g, feat), ops, F32_OPS)
        if library:
            lib_ms, lib_err = yardstick(feat, rois, out_size, g)
    share = bd["bound_ms"] / ms * 100
    phase(f"  {kernel} time at {what}: kernel {ms:.4f} ms ({share:.1f}% of bound), plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})"
          + ("" if lib_ms is None else
             f", library (grid_sample + avg_pool2d{', backward' if g is not None else ''}) "
             f"{lib_ms:.4f} ms, max abs diff from plain {lib_err:.3e}"))
    return dict(shape=what, ms=ms, plain_ms=plain_ms, pct_of_bound=share, library_ms=lib_ms,
                library_max_abs_diff=lib_err, **bd)


def phase_align_kernels(dev, rec):
    """K5 and K6 against their plain versions (chunked over RoIs): at every
    shape of ``tests/test_torch_kernels.py::ALIGN_SHAPES`` (K5 bit-equal with
    float32 and bfloat16 output, K6 within tolerance with float32 and
    bfloat16 g and bit-identical on repeat, bf16 and f32 feat); then at the
    align paths' shapes, with times, bounds and the library yardstick
    (:func:`yardstick`): VGG-16 VOC (8, 300) P=7 C=512 on 38 x 64 and R101
    COCO (8, 1000) P=14 C=1024 on 50 x 84, bf16 feat with bf16 output (the
    bf16 paths' call) and f32 feat with f32 output; K6 at each config's
    training RoI count (8, 128), with g in feat's dtype; the clipped,
    beyond-the-map, one-cell and sub-cell RoIs of :func:`align_case` in
    every case; a ragged small case (C = 36, not a multiple of the
    vector) too."""
    import importlib.util

    import torch

    # by path: the card's machine may have another top-level "tests" package
    spec = importlib.util.spec_from_file_location(
        "test_torch_kernels", Path(__file__).resolve().parent / "tests" / "test_torch_kernels.py")
    kernel_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kernel_tests)
    phase("RoIAlign kernels (K5 forward, K6 backward) vs plain versions:")
    err5 = err6 = 0.0
    rows5, rows6 = [], []
    for b, r, h, w, c, p in kernel_tests.ALIGN_SHAPES:
        rng = np.random.default_rng(r + c)
        feat = rng.standard_normal((b, h, w, c))
        rois_t = torch.tensor(kernel_tests._align_rois(rng, b, r, h, w), device=dev)
        g = torch.tensor(rng.standard_normal((b, r, p, p, c)), dtype=torch.float32, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            feat_t = torch.tensor(feat, dtype=dt, device=dev)
            shape = f"ALIGN_SHAPES ({b},{r}) P={p} C={c} {h}x{w} {str(dt)[6:]}"
            err5 = max(err5, check_align(feat_t, rois_t, shape, p))
            err6 = max(err6, check_align_bwd(feat_t, rois_t, g, shape))
    feat, rois = align_case(2, 37, 80, fh=9, fw=13, c=36)
    rois_t = torch.from_numpy(rois).to(dev)
    g = torch.from_numpy(np.random.default_rng(81).standard_normal(
        (2, 37, 7, 7, 36)).astype(np.float32)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        feat_t = torch.from_numpy(feat).to(dev, dt)
        err5 = max(err5, check_align(feat_t, rois_t, f"ragged (2,37) P=7 C=36 9x13 {dt}"))
        err6 = max(err6, check_align_bwd(feat_t, rois_t, g, f"ragged (2,37) P=7 C=36 9x13 {dt}"))
    for what, (fh, fw), p, c, r, seed in (("VGG VOC", (38, 64), 7, 512, 300, 82),
                                          ("R101 COCO", COCO_MAP, 14, 1024, 1000, 84)):
        feat, rois = align_case(8, r, seed, fh=fh, fw=fw, c=c)
        rois_t = torch.from_numpy(rois).to(dev)
        rois128 = rois_t[:, :128].contiguous()
        g = torch.randn((8, 128, p, p, c), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            feat_t = torch.from_numpy(feat).to(dev, dt)
            shape = f"(8,{r}) P={p} C={c} {name}, {what} {fh}x{fw} map"
            err5 = max(err5, check_align(feat_t, rois_t, shape, p))
            torch.cuda.empty_cache()
            # the yardstick's output at R101 COCO is 8 x 1024 x 28000 x 28 samples:
            # timed in four chunks of 250 RoIs, summed
            rows5.append(align_row("K5", f"{shape}, {name} output", feat_t, rois_t, out_size=p,
                                   library=True, chunk=250 if r == 1000 else None))
            torch.cuda.empty_cache()
            shape = f"(8,128) P={p} C={c} {name}, {what} {fh}x{fw} map"
            err6 = max(err6, check_align_bwd(feat_t, rois128, g, shape))
            gd = g.to(dt)
            rows6.append(align_row("K6", f"{shape}, {name} g", feat_t, rois128, gd, p,
                                   library=True))
            del feat_t, gd
            torch.cuda.empty_cache()
        del g
    main = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the records keep the R101 COCO bf16 row: the largest call on a main path
    rec["roi_align"] = dict(max_abs_err=err5, shapes=rows5, **{k: rows5[2][k] for k in main})
    rec["roi_align_bwd"] = dict(max_abs_err=err6, shapes=rows6, **{k: rows6[2][k] for k in main})


def int8_small_model(dev, stem: str, rng):
    """The small VGG-16 config's int8 model, float32 compute, on the CPU and
    on the card with the same seeded weights, and its images: with
    ``stem="exact"``, integer-valued images and conv1_1 / conv1_2 kernels
    (float32 sums exact in any order, so K3 and the CPU's stem agree bit
    for bit); "seeded", the init's weights on real-valued images."""
    import torch

    from trcnn_torch.models import make_model

    cfg = small_cfg("vgg16")
    cpu = make_model(cfg, device="cpu", quant="int8").init(torch.Generator().manual_seed(45))
    if stem == "exact":
        with torch.no_grad():
            cpu.extractor.conv1_1.weight.copy_(torch.from_numpy(
                rng.integers(-2, 3, (64, 3, 3, 3)).astype(np.float32)))
            cpu.extractor.conv1_2.weight.copy_(torch.from_numpy(
                (rng.integers(-2, 3, (64, 64, 3, 3)) / 16).astype(np.float32)))
        images = rng.integers(-8, 9, (2, 64, 96, 3)).astype(np.float32)
    else:
        images = (rng.standard_normal((2, 64, 96, 3)) * 40).astype(np.float32)
    gpu = make_model(cfg, device=dev, quant="int8")
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu.eval(), gpu.eval(), torch.from_numpy(images)


def phase_int8_small(dev):
    """int8 detect on the card against the port's CPU int8 detect on the
    small VGG-16 config, float32 compute, with every quantized input's
    codes recorded on both sides.  "exact" stem: no code apart at any of
    the 13 quantized inputs (the int8 products are exact, the scales and
    the dequantization the same float32 operations), proposals within
    1e-3 pixels, cls_prob within 1e-4 relative, the detections' validity
    and classes equal.  "seeded" stem: the stems differ in the last bits,
    the codes apart are printed per layer, and cls_prob is held within 1e-2
    and bbox_pred within 5e-2 of their largest magnitude (the CPU test's
    tolerances for the same effect against JAX)."""
    import torch

    from trcnn_torch.models import postprocess
    from trcnn_torch.ops import quant

    rng = np.random.default_rng(46)
    info = torch.tensor([[60.0, 90.0, 1.2], [64.0, 80.0, 1.0]])
    for stem in ("exact", "seeded"):
        cfg, cpu, gpu, images = int8_small_model(dev, stem, rng)
        codes, outs = {}, {}
        real = quant.quantize_tensor
        for side, model, x, i in (("cpu", cpu, images, info),
                                  ("card", gpu, images.to(dev), info.to(dev))):
            codes[side] = []

            def record(t, _codes=codes[side]):
                q, sc = real(t)
                _codes.append(q.cpu())
                return q, sc

            quant.quantize_tensor = record
            try:
                with torch.no_grad():
                    raw = model.detect(x, i)
                    dets = postprocess(raw, i, cfg, score_thresh=0.02)
            finally:
                quant.quantize_tensor = real
            outs[side] = ([t.cpu() for t in raw], [t.cpu() for t in dets])
        apart = [int((a != b).sum()) for a, b in zip(codes["cpu"], codes["card"])]
        (raw_c, det_c), (raw_g, det_g) = outs["cpu"], outs["card"]
        what = f"small VGG-16 int8, {stem} stem"
        if len(apart) != 13 or not torch.equal(raw_g[1], raw_c[1]):
            raise AssertionError(f"{what}: {len(apart)} quantized inputs, proposals' validity "
                                 f"{'equal' if torch.equal(raw_g[1], raw_c[1]) else 'differs'}")
        rel = [float((g - c).abs().max()) / float(c.abs().max()) for g, c in
               ((raw_g[2], raw_c[2]), (raw_g[3], raw_c[3]))]
        if stem == "exact":
            if any(apart):
                raise AssertionError(f"{what}: codes apart per quantized input {apart}")
            torch.testing.assert_close(raw_g[0], raw_c[0], rtol=1e-5, atol=1e-3)
            torch.testing.assert_close(raw_g[2], raw_c[2], rtol=1e-4, atol=1e-5)
            if not (torch.equal(det_g[3], det_c[3]) and torch.equal(det_g[2], det_c[2])):
                raise AssertionError(f"{what}: detections differ between card and CPU")
        elif rel[0] > 1e-2 or rel[1] > 5e-2:
            raise AssertionError(f"{what}: cls_prob {rel[0]:.2e}, bbox_pred {rel[1]:.2e} apart; "
                                 f"codes apart per quantized input {apart}")
        phase(f"{what}: card vs CPU, int8 codes apart at the 13 quantized inputs {apart}; "
              f"cls_prob {rel[0]:.2e}, bbox_pred {rel[1]:.2e} of their largest apart; "
              f"{int(det_c[3].sum())} CPU detections, "
              f"{'equal' if torch.equal(det_g[3], det_c[3]) else 'not compared'}")


def int8_layer_rows(mq, mb, images8, info8, what):
    """Each quantized layer of one int8 b=8 call, on its own input (bf16,
    recorded): the int8 GEMM alone (cuBLASLt), the whole int8 layer
    (quantize, im2col, GEMM, dequantize with the bias) and the bf16 layer
    of the bf16 model on the same input (cuDNN's convolution + bias, or
    cuBLAS's dense + bias), CUDA events; with the int8 GEMM's share of its
    bound (operations at 1,979 TOP/s, or its bytes)."""
    import torch

    from trcnn_torch.models import roi_head, vgg16
    from trcnn_torch.ops import quant

    seen = []
    real_c, real_d = vgg16.qconv2d, roi_head.qdense
    vgg16.qconv2d = lambda x, layer: (seen.append(("conv", x.clone(), layer)), real_c(x, layer))[1]
    roi_head.qdense = lambda x, layer: (seen.append(("dense", x.clone(), layer)), real_d(x, layer))[1]
    try:
        with torch.inference_mode():
            mq.detect(images8, info8)
        torch.cuda.synchronize()
    finally:
        vgg16.qconv2d, roi_head.qdense = real_c, real_d
    names = {id(m): n for n, m in mq.named_modules()}
    bf16 = dict(mb.named_modules())
    total = {"gemm": 0.0, "int8": 0.0, "bf16": 0.0}
    phase(f"  int8 layers at {what}, ms (CUDA events): int8 GEMM / whole int8 layer / bf16 layer")
    with torch.inference_mode():
        for kind, x, layer in seen:
            name = names[id(layer)]
            wq, _ = quant.weight_codes(layer)
            xq, _ = quant.quantize_tensor(x)
            if kind == "conv":
                a = quant.im2col(xq, *layer.kernel_size, layer.padding)
                xb = x.permute(0, 3, 1, 2)                  # the bf16 trunk's channels-last view
                ref = lambda: vgg16.conv_nchw(xb, bf16[name], relu=False)  # noqa: E731
                whole = lambda: quant.qconv2d(x, layer)  # noqa: E731
            else:
                a = xq
                ref = lambda: roi_head.dense(x, bf16[name])  # noqa: E731
                whole = lambda: quant.qdense(x, layer)  # noqa: E731
            gemm = cuda_time_ms(lambda: quant.int8_matmul(a, wq), warmup=2, iters=10)
            ms_int8 = cuda_time_ms(whole, warmup=2, iters=10)
            ms_bf16 = cuda_time_ms(ref, warmup=2, iters=10)
            m, k, n = a.shape[0], a.shape[1], wq.shape[0]
            bd = bound(nbytes(a, wq) + m * n * 4, 2.0 * m * k * n, 1979e12)
            for key, v in (("gemm", gemm), ("int8", ms_int8), ("bf16", ms_bf16)):
                total[key] += v
            phase(f"    {name.split('.')[-1]} ({m}x{k})x({k}x{n}): {gemm:.4f} / {ms_int8:.4f} / "
                  f"{ms_bf16:.4f}; GEMM {bd['bound_ms'] / gemm * 100:.1f}% of its bound "
                  f"({bd['bound_by']}), {2.0 * m * k * n / gemm / 1e9:.1f} TOP/s")
            del a
    phase(f"    sum over the {len(seen)} layers: int8 GEMMs {total['gemm']:.3f} ms, whole int8 "
          f"layers {total['int8']:.3f} ms, bf16 layers {total['bf16']:.3f} ms")
    del seen
    torch.cuda.empty_cache()


def phase_int8(dev, by_path):
    """The int8 VGG-16 detect path at full width through
    ``entry(quant="int8")`` (weights kept float32, as bench.py does), on the
    VOC config (a request and a batch of 8) and on the COCO config (a
    batch of 8, calibrated weights): each a counted path; beside the bf16
    model of the same weights in the same call, in turns (bf16, int8,
    int8, bf16, medians of 3 calls each); profiles of both; peak memory;
    each quantized layer against its bf16 layer (:func:`int8_layer_rows`);
    and the share of int8 detections whose class agrees with bf16's."""
    import torch

    from trcnn_torch import _build
    from trcnn_torch.entry import entry

    for coco in (False, True):
        cfg = coco_cfg() if coco else None
        what = "COCO" if coco else "VOC"
        fq, (mq, image, info) = entry(dev, cfg=cfg, quant="int8")
        fb, (mb, _, _) = entry(dev, cfg=cfg)
        gen = torch.Generator(device=dev).manual_seed(9)
        images8 = torch.randint(0, 256, (8,) + image.shape[1:], dtype=torch.uint8,
                                generator=gen, device=dev)
        info8 = info.expand(8, 3).contiguous()
        if coco:
            calibrate(mq, images8[:2], info8[:2], head=True)
        mb.load_state_dict(mq.state_dict())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        path = path_name("vgg16", "detect", "int8", coco)
        _build.reset_launch_counts()
        if not coco:
            check_dets(fq(mq, image, info), 1)
        dets8 = fq(mq, images8, info8)
        torch.cuda.synchronize()
        check_dets(dets8, 8)
        launches = dict(_build.launch_counts)
        require_launches(path, launches)
        by_path[path] = launches
        require_nms_launches(f"int8 {what} detect b=8", lambda: fq(mq, images8, info8), 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        arms = {"bf16": lambda: fb(mb, images8, info8), "int8": lambda: fq(mq, images8, info8)}
        ms = {"bf16": [], "int8": []}
        for arm in ("bf16", "int8", "int8", "bf16"):
            ms[arm].append(host_ms(arms[arm], 3))
        req = ""
        if not coco:
            req = (f"; request int8 {host_ms(lambda: fq(mq, image, info), 3):.2f} ms, bf16 "
                   f"{host_ms(lambda: fb(mb, image, info), 3):.2f} ms")
        with torch.inference_mode():
            db = fb(mb, images8, info8)
        both = dets8.valid & db.valid
        agree = int((dets8.classes[both] == db.classes[both]).sum())
        phase(f"int8 {what} VGG-16 detect: launches {launches}; b=8 int8 "
              f"{', '.join(f'{t:.2f}' for t in ms['int8'])} ms, bf16 "
              f"{', '.join(f'{t:.2f}' for t in ms['bf16'])} ms (in turns){req}; peak "
              f"{peak:.2f} GiB; detections per image {dets8.valid.sum(-1).tolist()}, classes "
              f"equal to bf16's in {agree} of the {int(both.sum())} slots valid in both")
        profile_window(arms["int8"], 2, f"int8 {what} detect b=8", top_all=True)
        profile_window(arms["bf16"], 2, f"bf16 {what} detect b=8 (same weights)", top_all=True)
        int8_layer_rows(mq, mb, images8, info8, f"{what} b=8")
        del mq, mb, fq, fb, arms, dets8, db
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- data parallel
#
# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device); each is this script, started as ``chip_smoke.py --dp-rank SPEC
# RANK``.  NCCL runs at world size 1, through the train CLI's --distributed.

DP_WORLD = 2
# Each data-parallel step against one process's step on the same global
# batch from the same state, float32 (the train CLI's default; TF32 off):
# on the card two runs of one process part after their first step
# (cuDNN's and the index ops' backward add with atomics: two runs of the
# train CLI on an H100, grad_norm 3.7e-3 apart at the second step), so
# rank 0 takes the reference step before each data-parallel one and
# restores the state.
# Losses and grad_norm relative: 1e-5 (the ranks' shares are summed in
# another order than one process sums the batch) where the trunk gives the
# same bits at 4 images as at 8; where it does not (the convolutions may
# take other algorithms: ResNet-101 COCO's second step on an H100), the
# reference samples from the proposals the ranks' halves give (which the
# last bits can move), and its features still differ in their last bits:
# 1e-3.  grad_norm where the bits are equal: 1e-4, not 1e-5 (the
# backward's atomics order the gradients' sums differently on every run:
# 2.1e-5 at VGG-16 VOC's third step on an H100).
DP_RTOL = (1e-5, 1e-3)
DP_NORM_RTOL = 1e-4
DP_TIMEOUT_S = 600


def config_from_dict(d: dict, cls=None):
    """The port's config from ``dataclasses.asdict`` of one (a rank gets
    its config in its spec)."""
    import dataclasses
    import typing

    from trcnn_torch.config import FasterRCNNConfig

    cls = cls or FasterRCNNConfig
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v, t = d[f.name], hints[f.name]
        if dataclasses.is_dataclass(t):
            v = config_from_dict(v, t)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def rows(tree, rank: int, world: int):
    """Rank ``rank``'s block of rows (of ``world`` equal blocks) of every
    tensor in ``tree`` (a tensor, dict, list or tuple)."""
    import torch

    if torch.is_tensor(tree):
        b = tree.shape[0] // world
        return tree[rank * b:(rank + 1) * b].contiguous()
    if isinstance(tree, dict):
        return {k: rows(v, rank, world) for k, v in tree.items()}
    return type(tree)(rows(v, rank, world) for v in tree)


def digest(model, momentum=None, names=None) -> str:
    """sha256 over every parameter's bytes (and, given the optimizer's
    momentum buffers, theirs; given ``names``, those parameters only):
    equal digests, bit-identical replicas."""
    import hashlib

    import torch

    def raw(t):
        return t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()

    h = hashlib.sha256()
    for name, p in model.named_parameters():
        if names is not None and name not in names:
            continue
        h.update(name.encode())
        h.update(raw(p))
        if momentum is not None:
            h.update(raw(momentum[name]))
    return h.hexdigest()


@contextlib.contextmanager
def sampled_sets(records: list):
    """Record what ``FasterRCNN.losses`` samples, one dict per call: the
    anchor labels (B, N) and the sampled RoIs, labels and valid slots."""
    from trcnn_torch.models import faster_rcnn

    real_at, real_pt = faster_rcnn.anchor_targets, faster_rcnn.proposal_targets

    def at(*args, **kw):
        out = real_at(*args, **kw)
        records.append({"at_labels": out.labels.cpu()})
        return out

    def pt(*args, **kw):
        out = real_pt(*args, **kw)
        records[-1].update(pt_rois=out.rois.cpu(), pt_labels=out.labels.cpu(),
                           pt_valid=out.valid.cpu())
        return out

    faster_rcnn.anchor_targets, faster_rcnn.proposal_targets = at, pt
    try:
        yield records
    finally:
        faster_rcnn.anchor_targets, faster_rcnn.proposal_targets = real_at, real_pt


def run_steps(state, batches, uniforms=None, proposals=None):
    """``train_step`` over ``batches`` (this process's rows, on the model's
    device); per step the metrics, the sampled sets, the replica's digest
    and the host-clock ms (synchronised on the card)."""
    import torch

    from trcnn_torch.train.step import train_step

    out = []
    cuda = next(state.model.parameters()).is_cuda
    for i, batch in enumerate(batches):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sampled_sets([]) as rec:
            m = train_step(state, batch, uniforms=uniforms[i] if uniforms else None,
                           proposals=proposals[i] if proposals else None)
            metrics = {k: float(v) for k, v in m.items()}
        ms = (time.perf_counter() - t0) * 1e3
        out.append({"metrics": metrics, "sampled": rec[0], "ms": ms,
                    "digest": digest(state.model, state.optimizer.momentum)})
    return out


def compare_steps(ref, ranks, what, rtol):
    """World ``len(ranks)`` against one process on the same global batches
    (``ref``, a step each, from :func:`reference_step`): the replicas'
    digests equal after every step; the anchor samples, the sampled RoIs
    (labels, valid slots, boxes within 1e-2 pixel) and the sample counts
    equal; losses and grad_norm within ``rtol`` (its first entry where the
    trunk gave the same bits at both batch sizes, its second elsewhere),
    grad_norm within DP_NORM_RTOL at least."""
    import torch

    for i, want in enumerate(ref):
        steps = [r[i] for r in ranks]
        if len({s["digest"] for s in steps}) != 1:
            raise AssertionError(f"{what}: the replicas differ after step {i + 1}")
        got = {k: torch.cat([s["sampled"][k] for s in steps]) for k in want["sampled"]}
        s = want["sampled"]
        if not torch.equal(got["at_labels"], s["at_labels"]):
            raise AssertionError(f"{what}: step {i + 1} sampled other anchors")
        bad = ((got["pt_labels"] != s["pt_labels"]) | (got["pt_valid"] != s["pt_valid"])
               | ((got["pt_rois"] - s["pt_rois"]).abs() > 1e-2).any(-1))
        if bad.any():
            raise AssertionError(f"{what}: step {i + 1} sampled {int(bad.sum())} other RoIs")
        tol = rtol[not want["same_trunk"]]
        for k, v in want["metrics"].items():
            mine = {s["metrics"][k] for s in steps}
            if len(mine) != 1:
                raise AssertionError(f"{what}: the ranks report different {k}: {mine}")
            (x,) = mine
            k_tol = 0 if k.startswith("num_fg") else max(tol, DP_NORM_RTOL * (k == "grad_norm"))
            if abs(x - v) > k_tol * abs(v):
                raise AssertionError(f"{what}: step {i + 1} {k} {x} vs one process's {v}")


def launch_ranks(spec: dict, tmp: str):
    """Start ``spec["world"]`` ranks (DP_WORLD by default; this script with
    ``--dp-rank``), wait for them
    (at most ``DP_TIMEOUT_S``, every rank killed if one fails or the time
    runs out) and return each rank's results."""
    import dataclasses
    import os

    import torch

    world = spec.get("world", DP_WORLD)
    spec = dict(spec, store=f"file://{tmp}/store_{spec['name']}", world=world, out=tmp,
                cfg=dataclasses.asdict(spec["cfg"]))
    path = os.path.join(tmp, f"spec_{spec['name']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [os.path.join(tmp, f"{spec['name']}.{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen([sys.executable, __file__, "--dp-rank", path, str(r)],
                                              stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + DP_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    for r, p in enumerate(procs):
        text = open(logs[r]).read()
        log_file("dp.txt", f"$ rank {r} of {spec['name']} (exit {p.returncode})\n{text}")
        if p.returncode != 0:
            raise AssertionError(f"data-parallel rank {r} of {spec['name']} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
    return [torch.load(os.path.join(tmp, f"{spec['name']}.{r}.pt"), weights_only=False)
            for r in range(world)]


def dp_config(preset: str, backbone: str):
    """The config of a data-parallel phase: "small" (the small training
    config with the head's dropout on), "voc" or "coco"."""
    from trcnn_torch.config import voc_config

    if preset == "small":
        return train_cfg(backbone).replace(head_dropout=0.5)
    if preset == "coco":
        return coco_cfg(backbone)
    return voc_config().replace(backbone=backbone)


def dp_model(cfg, dev, dtype, state=None):
    """The seeded model of the full-width phases (``train_entry``'s init),
    or one with the parameters of ``state``."""
    import torch

    from trcnn_torch.models import make_model

    model = make_model(cfg, dtype=dtype, device=dev)
    if state is not None:
        model.load_state_dict(state)
        return model
    return model.init(torch.Generator(device=dev).manual_seed(0))


def reference_step(state, batch, world: int, keep_params: bool = False):
    """One process's step from ``state`` on the whole ``batch`` (as
    :func:`run_steps` reports it, and whether the trunk gives the batch's
    ``world`` blocks, one rank's images each, the bits it gives the
    batch), ``state`` restored after.  Where it does not, the step samples
    from the proposals the blocks give: those the ranks sample from.
    ``keep_params``: the parameters after the step too."""
    import torch

    from trcnn_torch import parallel

    model = state.model
    same = trunk_equal(model, batch["images"], batch["im_info"], world)
    proposals = None
    if not same:
        with torch.no_grad():
            parts = [model.propose(model.rpn(model.extractor(model._prepare(
                b["images"], b["im_info"]))), b["im_info"], train=True)
                for b in (rows(batch, r, world) for r in range(world))]
        proposals = [tuple(torch.cat(t) for t in zip(*parts))]
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    momentum = {k: v.clone() for k, v in state.optimizer.momentum.items()}
    step, mesh = state.step, state.mesh
    state.mesh = parallel.Mesh()
    (ref,) = run_steps(state, [batch], proposals=proposals)
    with torch.no_grad():
        if keep_params:
            ref["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.copy_(params[k])
            state.optimizer.momentum[k].copy_(momentum[k])
    state.step, state.mesh = step, mesh
    ref["same_trunk"] = same
    return ref


def dp_train_job(job, dev, rank, world, group):
    """A rank's train steps on its rows of the global batches.  Before
    each, rank 0 takes one process's step from the same state on the whole
    global batch (:func:`reference_step`).  The other ranks start from
    other weights, which the state's broadcast overwrites.  Returns the
    steps, the references, the launches of the data-parallel steps alone,
    the replay of their kernel calls (the first of each input shape in
    each step, every K1 call) through the plain versions on this rank's
    device, peak memory and one timed all-reduce of the gradients."""
    import torch

    from trcnn_torch import _build, parallel
    from trcnn_torch.train.step import TrainState

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dtype = getattr(torch, job["dtype"])
    state0 = torch.load(job["state"]) if job.get("state") else None
    model = dp_model(config_from_dict(job["cfg"]), dev, dtype, state0)
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    state = TrainState.create(model, parallel.make_mesh())
    digest0 = digest(model)
    batches = [{k: v.to(dev) for k, v in b.items()} for b in torch.load(job["batches"])]
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    refs, steps, captured = [], [], {}
    launches = dict.fromkeys(_build.launch_counts, 0)
    for batch in batches:
        if rank == 0:
            refs.append(reference_step(state, batch, world))
        sync()
        before = dict(_build.launch_counts)
        with recording(captured, first_of_shape=True):
            steps += run_steps(state, [rows(batch, rank, world)])
        sync()
        for k in launches:
            launches[k] += _build.launch_counts[k] - before[k]
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    checked = replay(captured, f"rank {rank}'s data-parallel steps")
    del captured
    grads = [p.grad.clone() for p in model.parameters() if p.grad is not None]
    times = []
    for _ in range(3):
        parallel.barrier(group)
        sync()
        t0 = time.perf_counter()
        parallel.all_reduce_sum_(grads, group)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"steps": steps, "refs": refs, "digest0": digest0, "launches": launches,
            "replay": checked, "peak_gib": peak, "allreduce_ms": statistics.median(times),
            "allreduce_bytes": sum(g.numel() * g.element_size() for g in grads)}


def dp_eval_job(job, dev, rank, world, group):
    """A rank's share of the sharded evaluation (on ``job["gt"]``'s ground
    truth, where given); its detections (every rank's, merged), metrics,
    timing, launches and the replay of its kernel calls (the first of each
    input shape, every K1 call) through the plain versions."""
    import torch

    from trcnn_torch import _build
    from trcnn_torch.data import SyntheticDetection
    from trcnn_torch.eval import Evaluator

    cfg = config_from_dict(job["cfg"])
    model = eval_model(cfg, dev)
    ds = SyntheticDetection(**job["dataset"])
    if job.get("gt"):
        ds = GroundTruthFrom(ds, torch.load(job["gt"], weights_only=False))
    ev = Evaluator(model, cfg, ds, batch_size=job["batch_size"], device=dev, group=group)
    _build.reset_launch_counts()
    captured = {}
    with recording(captured, first_of_shape=True):
        metrics = ev()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    checked = replay(captured, f"rank {rank}'s share of the evaluation")
    return {"metrics": metrics, "detections": ev.detections, "timing": ev.timing,
            "local_images": ev.last_local_images, "launches": launches,
            "replay": checked, "digest": digest(model)}


def dp_rank_main(spec_path: str, rank: int) -> int:
    """One rank: join the gloo group (on card 0, or on the CPU for a
    rehearsal), run the spec's job, save its result for the parent."""
    import torch
    import torch.distributed as dist

    from trcnn_torch import parallel

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = spec["device"] == "cuda"
    dev = parallel.initialize(spec["store"], spec["world"], rank,
                              local_device_ids=[0] if cuda else None, backend="gloo")
    try:
        job = {"train": dp_train_job, "eval": dp_eval_job, "grid": grid_job}[spec["kind"]]
        res = job(spec, dev, rank, spec["world"], dist.group.WORLD)
        torch.save(res, f"{spec['out']}/{spec['name']}.{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def dp_global_batches(cfg, coco: bool, n: int):
    """``n`` global batches of 8 on the host: the loader's multi-scale COCO
    batches, or VOC canvases of seeded uint8 noise with ``train_entry``'s
    gt."""
    import torch

    from trcnn_torch.entry import TRAIN_GT_BOXES, TRAIN_GT_LABELS
    from trcnn_torch.train.step import device_batch

    if coco:
        from trcnn_torch.data import DetectionLoader, SyntheticDetection

        loader = DetectionLoader(SyntheticDetection(n=8 * n, num_classes=cfg.num_classes, seed=5),
                                 batch_size=8, image_cfg=cfg.image, augment=True, shuffle=True,
                                 seed=1, uint8_images=True)
        return [device_batch(b, torch.device("cpu")) for b in loader][:n]
    g = len(TRAIN_GT_LABELS)
    out = []
    for i in range(n):
        gen = torch.Generator().manual_seed(100 + i)
        out.append({
            "images": torch.randint(0, 256, (8, cfg.image.pad_h, cfg.image.pad_w, 3),
                                    dtype=torch.uint8, generator=gen),
            "im_info": torch.tensor([[600.0, 1000.0, 1.6]]).expand(8, 3).contiguous(),
            "gt_boxes": torch.tensor(TRAIN_GT_BOXES).expand(8, g, 4).contiguous(),
            "gt_labels": torch.tensor(TRAIN_GT_LABELS, dtype=torch.int32).expand(8, g)
            .contiguous(),
            "gt_valid": torch.ones((8, g), dtype=torch.bool)})
    return out


def trunk_equal(model, images, info, world: int) -> bool:
    """The trunk's bits for the batch equal those for its ``world`` blocks
    (one rank's images each): then both worlds sample from the same
    proposals."""
    import torch

    with torch.no_grad():
        whole = model.extractor(model._prepare(images, info))
        parts = torch.cat([model.extractor(model._prepare(rows(images, r, world),
                                                          rows(info, r, world)))
                           for r in range(world)])
    return torch.equal(whole, parts)


def phase_dp_train(dev, by_path, tmp, preset: str, backbone: str, n_steps: int):
    """Data-parallel training at full width: two gloo ranks on the card, 4
    images each, ``n_steps`` steps on global batches of 8 from seeded
    weights (float32, the train CLI's default; VOC canvases, or the
    loader's multi-scale COCO batches), each step against one process's
    step from the same state on the same global batch (rank 0's
    :func:`reference_step`).  The replicas bit-identical from the start
    (rank 1's own init overwritten by the broadcast) and after every step;
    the sampled sets equal; losses and grad_norm within DP_RTOL and
    DP_NORM_RTOL; each rank's data-parallel steps launch exactly the path's kernels.  Prints
    the step times, the all-reduce's time and bytes, and peak memory."""
    import os

    import torch

    cfg = dp_config(preset, backbone)
    job = {"name": f"{backbone}_{preset}_train", "kind": "train", "cfg": cfg,
           "dtype": "float32", "device": dev.type}
    job["batches"] = os.path.join(tmp, f"{job['name']}_batches.pt")
    torch.save(dp_global_batches(cfg, preset == "coco", n_steps), job["batches"])
    ranks = launch_ranks(job, tmp)
    ref = ranks[0]["refs"]
    what = (f"data parallel {NAMES[backbone]} {preset.upper()} train, float32, {DP_WORLD} "
            f"gloo ranks x 4 images")
    if len({r["digest0"] for r in ranks}) != 1:
        raise AssertionError(f"{what}: the replicas start from other weights")
    compare_steps(ref, [r["steps"] for r in ranks], what, DP_RTOL)
    same = [i + 1 for i, r in enumerate(ref) if r["same_trunk"]]
    path = path_name(backbone, "dp train", coco=preset == "coco")
    for r, res in enumerate(ranks):
        require_launches(path, res["launches"])
        by_path[f"{path} rank {r}"] = res["launches"]
    n_rois = ref[0]["sampled"]["pt_labels"].numel()
    phase(f"{what}, {n_steps} steps, each vs one process x 8 from the same state: replicas "
          f"bit-identical from the broadcast on; anchors and the {n_rois} sampled RoIs equal; "
          f"the trunk's bits at 4 images equal those at 8 at steps {same} of {n_steps} (where "
          f"not, the one process sampled from the ranks' proposals); losses within "
          f"{DP_RTOL[0]:g} there (grad_norm {DP_NORM_RTOL:g}), {DP_RTOL[1]:g} elsewhere")
    for i, want in enumerate(ref):
        got = ranks[0]["steps"][i]["metrics"]
        phase(f"  step {i + 1}, rank 0 (one process): " + ", ".join(
            f"{k} {got[k]:.6g} ({v:.6g})" for k, v in want["metrics"].items()))
    phase(f"  step ms (host clock; the ranks time-share the card, rank 1 waits while rank 0 "
          f"takes the one-process step; the ranks' steps include the capture of their kernel "
          f"inputs): one process {[round(s['ms'], 2) for s in ref]}; "
          + "; ".join(f"rank {r} {[round(s['ms'], 2) for s in res['steps']]}"
                      for r, res in enumerate(ranks)))
    for res in ranks:
        phase(f"  {res['replay']}")
    phase(f"  gradient all-reduce over gloo: {ranks[0]['allreduce_bytes'] / 2**20:.1f} MiB, "
          f"{ranks[0]['allreduce_ms']:.2f} / {ranks[1]['allreduce_ms']:.2f} ms (rank 0 / 1); "
          f"peak device memory per rank {ranks[0]['peak_gib']:.2f} / {ranks[1]['peak_gib']:.2f} "
          f"GiB; launches per rank {ranks[0]['launches']}")


def eval_model(cfg, dev):
    """The seeded bf16 model of the evaluation phases (graded class
    biases, so that random weights make detections), cast for
    inference."""
    import torch

    from trcnn_torch.models.faster_rcnn import cast_params_for_inference

    model = dp_model(cfg, dev, torch.bfloat16)
    with torch.no_grad():
        model.head.cls_score.bias.copy_(torch.linspace(-3.0, 3.0, cfg.num_classes))
    return cast_params_for_inference(model, torch.bfloat16).eval()


class GroundTruthFrom:
    """A dataset's images with other ground truth: ``gt`` maps an image id
    to its (boxes (G, 4), labels (G,)); the loader's examples stay the
    dataset's."""

    def __init__(self, dataset, gt: dict):
        self.dataset, self.gt = dataset, gt

    def __len__(self) -> int:
        return len(self.dataset)

    def get_example(self, i):
        return self.dataset.get_example(i)

    def get_size(self, i):
        return self.dataset.get_size(i)

    def get_annotation(self, i):
        ann = self.dataset.get_annotation(i)
        boxes, labels = self.gt[ann["id"]]
        return {"id": ann["id"], "boxes": boxes, "labels": labels}

    __getitem__ = get_example


def gt_from_detections(detections):
    """Ground truth that the detections hit, scored the same in any
    order of images: every detection scoring at least the median distinct
    score becomes a gt box of its class (a true positive: test-time NMS
    leaves no other detection of its class within IoU 0.5 of it, so the
    rest are false positives, every one scoring below every true positive,
    and ties in score never mix the two), and every third image also
    gets a gt box that no detection hits (recall, and so AP, below 1)."""
    scores = np.unique(np.concatenate([d["scores"] for d in detections]))
    s_hi = scores[len(scores) // 2]
    gt, missed = {}, 0
    for i, d in enumerate(sorted(detections, key=lambda d: d["id"])):
        keep = d["scores"] >= s_hi
        boxes = [d["boxes"][keep]]
        labels = [d["classes"][keep].astype(np.int32)]
        if i % 3 == 0 and len(d["classes"]):
            corner = np.asarray([[1.0, 1.0, 9.0, 9.0]], np.float32)
            same = d["boxes"][d["classes"] == d["classes"][0]]
            iw = np.clip(np.minimum(same[:, 2], 9.0) - np.maximum(same[:, 0], 1.0) + 1, 0, None)
            ih = np.clip(np.minimum(same[:, 3], 9.0) - np.maximum(same[:, 1], 1.0) + 1, 0, None)
            area = (same[:, 2] - same[:, 0] + 1) * (same[:, 3] - same[:, 1] + 1)
            if (iw * ih / (area + 81.0 - iw * ih) > 0.5).any():
                raise AssertionError(f"a detection hits the corner box of {d['id']}")
            boxes.append(corner)
            labels.append(d["classes"][:1].astype(np.int32))
            missed += 1
        gt[d["id"]] = (np.concatenate(boxes).astype(np.float32), np.concatenate(labels))
    return gt, int(sum(len(v[1]) for v in gt.values())) - missed, missed


def phase_dp_eval(dev, by_path, tmp):
    """The evaluator sharded over two gloo ranks on the card: VGG-16 VOC,
    bf16, 37 synthetic images of both canvas buckets, global batch 8 (4 a
    rank), against this process's evaluator at batch 4 on the same
    weights.  A first one-process pass (its kernel calls recorded and
    replayed through the plain versions) makes the ground truth
    (:func:`gt_from_detections`); a second one scores it.  Each image
    once, its detections equal, each rank's kernel calls replayed through
    the plain versions, and the same metrics on both ranks as in the one
    process, mAP above 0."""
    import os

    import torch

    from trcnn_torch.data import SyntheticDetection
    from trcnn_torch.eval import Evaluator

    cfg = dp_config("voc", "vgg16")
    dataset = {"n": 37, "hw_range": [[300, 800], [300, 800]], "seed": 7}
    model = eval_model(cfg, dev)
    base = SyntheticDetection(**dataset)
    first = Evaluator(model, cfg, base, batch_size=4, device=dev)
    captured = {}
    with recording(captured, first_of_shape=True):
        first_dets = first.collect_detections()
    replay(captured, "one-process evaluation at batch 4")
    del captured
    gt, n_hit, n_missed = gt_from_detections(first_dets)
    job = {"name": "vgg16_dp_eval", "kind": "eval", "cfg": cfg, "batch_size": 8,
           "device": dev.type, "dataset": dataset, "gt": os.path.join(tmp, "dp_eval_gt.pt")}
    torch.save(gt, job["gt"])
    ref = Evaluator(model, cfg, GroundTruthFrom(base, gt), batch_size=4, device=dev)
    want = ref()
    weights = digest(model)
    del model
    ranks = launch_ranks(job, tmp)
    what = f"data parallel evaluation, VGG-16 VOC bf16, {DP_WORLD} gloo ranks"
    if any(r["digest"] != weights for r in ranks):
        raise AssertionError(f"{what}: a rank evaluates other weights")
    if ranks[0]["detections"] is None or any(
            [d["id"] for d in r["detections"]] != [d["id"] for d in ranks[0]["detections"]]
            for r in ranks):
        raise AssertionError(f"{what}: the ranks merged different lists")
    ids = [d["id"] for d in ranks[0]["detections"]]
    if sorted(ids) != sorted(d["id"] for d in ref.detections) or len(set(ids)) != 37:
        raise AssertionError(f"{what}: images missing or repeated: {len(ids)} ids")
    mine = {d["id"]: d for d in ranks[0]["detections"]}
    again = {d["id"]: d for d in first_dets}
    n_dets = 0
    for d in ref.detections:
        for src, other in (("the ranks'", mine[d["id"]]), ("the first pass's", again[d["id"]])):
            if not all(np.array_equal(other[k], d[k]) for k in ("boxes", "scores", "classes")):
                raise AssertionError(f"{what}: image {d['id']}'s detections in {src} list "
                                     f"differ from the one process's")
        n_dets += len(d["scores"])
    keys = [k for k in want if k != "eval_seconds"]
    for r, res in enumerate(ranks):
        far = {k: (res["metrics"][k], want[k]) for k in keys if res["metrics"][k] != want[k]}
        if far:
            raise AssertionError(f"{what}: rank {r}'s metrics differ from one process's: {far}")
    if not want["eval_mAP"] > 0:
        raise AssertionError(f"{what}: mAP {want['eval_mAP']} on gt the detections hit")
    buckets = set().union(*(r["timing"]["batches"] for r in ranks))
    if len(buckets) != 2 or ranks[0]["metrics"]["eval_images"] != 37:
        raise AssertionError(f"{what}: buckets {buckets}, {ranks[0]['metrics']['eval_images']} "
                             "images")
    for r, res in enumerate(ranks):
        require_launches("vgg16 dp evaluate", res["launches"])
        by_path[f"vgg16 dp evaluate rank {r}"] = res["launches"]
    phase(f"{what} vs one process at batch 4: 37 images once each ({n_dets} detections equal), "
          f"canvases {sorted(buckets)}, local images {[r['local_images'] for r in ranks]}; "
          f"gt from the one process's detections ({n_hit} hit, {n_missed} missed): mAP "
          f"{ranks[0]['metrics']['eval_mAP']:.6f} on both ranks, equal to the one process's, "
          f"every per-class AP equal too; eval seconds "
          f"{[round(r['metrics']['eval_seconds'], 2) for r in ranks]} vs "
          f"{want['eval_seconds']:.2f}; launches per rank {ranks[0]['launches']}")
    for res in ranks:
        phase(f"  {res['replay']}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_nccl_cli(dev, by_path, tmp):
    """NCCL at world size 1: the train CLI with --distributed (RANK=0,
    WORLD_SIZE=1 and a free port in the environment), VGG-16 VOC at batch
    8, float32, 2 steps, the evaluator hook and a checkpoint each step,
    against the same run without the flag.  Two runs of the same command
    agree at the first step and part after it on the card (cuDNN's and
    the index ops' backward add with atomics), so: the first step's log
    line equal, and each trained tensor of its checkpoint within 1e-3 of
    its move from the seeded init (L2), the frozen ones bit-equal; the
    second step's losses and grad_norm within 1e-2 relative, its
    checkpoint finite, the evaluation's image count equal and its mAP
    within 1e-2; the kernel calls of the run with the flag (the first of
    each input shape, every K1 call) replayed through the plain versions.
    Then, in the same group, the bf16
    train step at batch 8 with and without it in turns (the step's own
    all-reduces at world size 1), and the gradient all-reduce's time and
    bytes."""
    import contextlib
    import io
    import os

    import torch
    import torch.distributed as dist

    from trcnn_torch import parallel
    from trcnn_torch.cli import train
    from trcnn_torch.config import voc_config
    from trcnn_torch.entry import train_entry
    from trcnn_torch.train.optim import is_frozen
    from trcnn_torch.train.trainer import checkpoints

    def run(out, extra):
        text = io.StringIO()
        argv = ["--dataset", "synthetic", "--batch_size", "8", "--iters", "2", "--eval_every",
                "2", "--eval_limit", "16", "--log_every", "1", "--checkpoint_every", "1",
                "--out", os.path.join(tmp, out), "--device", dev.type] + extra
        with contextlib.redirect_stdout(text):
            trainer, launches = count_path(
                f"vgg16 train CLI {'nccl' if extra else 'without group'}", by_path,
                lambda: train.run(argv))
        log_file("cli.txt", f"$ trcnn_torch.cli.train {' '.join(argv)}\n{text.getvalue()}")
        lines = [json.loads(x) for x in text.getvalue().splitlines() if x.startswith("{")]
        cks = [torch.load(f, map_location="cpu") for _, f in checkpoints(os.path.join(tmp, out))]
        return trainer, launches, lines, cks

    plain = run("cli_plain", [])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        captured = {}
        with recording(captured, first_of_shape=True):
            nccl = run("cli_nccl", ["--distributed"])
        replay(captured, "train CLI --distributed (first call of each kernel input shape)")
        del captured
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != backend or nccl[0].group is None:
            raise AssertionError(f"--distributed did not make a {backend} group for the trainer")
        what = "train CLI --distributed (NCCL, world size 1)"
        drop = ("imgs_per_sec", "eval_seconds")
        (p1, p2, pe), (n1, n2, ne) = ([{k: v for k, v in r.items() if k not in drop}
                                       for r in run_[2]] for run_ in (plain, nccl))
        far = [k for k in ("loss", "rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss",
                           "grad_norm") if abs(n2[k] - p2[k]) > 1e-2 * abs(p2[k])]
        if (n1 != p1 or far or ne["eval_images"] != pe["eval_images"]
                or abs(ne["eval_mAP"] - pe["eval_mAP"]) > 1e-2):
            raise AssertionError(f"{what}: logs {[n1, n2, ne]} vs without the flag "
                                 f"{[p1, p2, pe]}")
        init = {k: v.cpu() for k, v in dp_model(voc_config(), dev, torch.float32)
                .state_dict().items()}
        (a1, a2), (b1, b2) = plain[3], nccl[3]
        if [c["step"] for c in (a1, a2, b1, b2)] != [1, 2, 1, 2]:
            raise AssertionError(f"{what}: checkpoints at steps {[c['step'] for c in (a1, b1)]}")
        worst, apart = 0.0, []
        for k, v in a1["model"].items():
            moved = float((v - init[k]).norm())
            if is_frozen(k):
                if moved or not torch.equal(b1["model"][k], v):
                    raise AssertionError(f"{what}: frozen {k} moved")
                continue
            err = float((b1["model"][k] - v).norm())
            worst = max(worst, err / moved if moved else err * float("inf"))
            moved2 = float((a2["model"][k] - init[k]).norm())
            apart.append(float((b2["model"][k] - a2["model"][k]).norm()) / max(moved2, 1e-30))
        if worst > 1e-3 or not all(np.isfinite(apart)):
            raise AssertionError(f"{what}: the step-1 checkpoint is {worst:.3e} of a move away "
                                 "from the run without the flag")
        phase(f"{what}: 2 steps at batch 8 + the eval hook; step 1 {n1} equal, its checkpoint "
              f"within {worst:.2e} of each tensor's move (L2); step 2 within "
              f"{max(abs(n2[k] - p2[k]) / abs(p2[k]) for k in p2 if p2[k]):.2e} relative, its "
              f"checkpoint {max(apart):.2e} of a move apart at most (the runs part after step "
              f"1); evaluation {ne}; launches {nccl[1]}")
        del plain, nccl, a1, a2, b1, b2, init

        step_fn, (state, batch) = train_entry(dev)
        group, mesh = dist.group.WORLD, parallel.make_mesh()
        step_fn(state, batch)
        ms = {"without": [], "with": []}
        for arm in ("without", "with", "with", "without"):
            state.mesh = mesh if arm == "with" else parallel.Mesh()
            ms[arm].append(host_ms(lambda: step_fn(state, batch), 3))
        grads = [p.grad.clone() for p in state.model.parameters() if p.grad is not None]
        nbytes_ = sum(g.numel() * g.element_size() for g in grads)
        reduce_ms = host_ms(lambda: parallel.all_reduce_sum_(grads, group), 5)
        phase(f"  VGG-16 VOC train step b=8, median of 3, in turns: without the group "
              f"{', '.join(f'{t:.2f}' for t in ms['without'])} ms, with it (NCCL, world size "
              f"1) {', '.join(f'{t:.2f}' for t in ms['with'])} ms; the gradient all-reduce "
              f"alone {reduce_ms:.3f} ms for {nbytes_ / 2**20:.1f} MiB")
        del state, batch, grads
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()


def phase_dp_small(dev):
    """The small VGG-16 training config (dropout on) on two gloo ranks on
    the card, float32: 2 steps on global batches of 2, each against one
    process's step from the same state on the card, the replicas
    bit-identical, the sampled sets equal, losses within DP_RTOL's first
    entry, grad_norm within DP_NORM_RTOL.  The card test runs it too."""
    import tempfile

    import torch

    cfg = dp_config("small", "vgg16")
    job = {"name": "small_dp_train", "kind": "train", "cfg": cfg, "dtype": "float32",
           "device": dev.type}
    rng = np.random.default_rng(5)
    gtb = torch.tensor([[[10, 12, 70, 60], [90, 30, 170, 100]], [[20, 15, 95, 80],
                                                                 [100, 40, 150, 95]]],
                       dtype=torch.float32)
    batches = [{"images": torch.from_numpy(rng.integers(0, 256, (2, 128, 192, 3),
                                                        dtype=np.uint8)),
                "im_info": torch.tensor([[120.0, 180.0, 1.2], [100.0, 160.0, 1.0]]),
                "gt_boxes": gtb, "gt_labels": torch.tensor([[3, 7], [5, 18]], dtype=torch.int32),
                "gt_valid": torch.ones((2, 2), dtype=torch.bool)} for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        cpu = small_model("vgg16", cfg, 3, batches[0]["images"].float(), batches[0]["im_info"],
                          head=False)
        job["state"] = f"{tmp}/state.pt"
        job["batches"] = f"{tmp}/batches.pt"
        torch.save(cpu.state_dict(), job["state"])
        torch.save(batches, job["batches"])
        ranks = launch_ranks(job, tmp)
    what = "small VGG-16 training config, 2 gloo ranks on the card"
    ref = ranks[0]["refs"]
    if not all(r["same_trunk"] for r in ref):
        raise AssertionError(f"{what}: the trunk's bits at 1 image differ from those at 2")
    compare_steps(ref, [r["steps"] for r in ranks], what, DP_RTOL)
    phase(f"{what}: 2 steps, each equal to one process's from the same state (replicas "
          f"bit-identical, sampled sets equal, losses within {DP_RTOL[0]:g}, grad_norm "
          f"{DP_NORM_RTOL:g})")


# ---------------------------------------------------------------- tensor parallel
#
# Four gloo ranks on a 2 x 2 (data, model) grid share the one card, each
# this script with ``--dp-rank``, as the data-parallel ranks are: fc6 and
# fc7 sharded over the model axis (``trcnn_torch.parallel.tensor``).

GRID = (2, 2)
# A grid step against one process's step from the same state: each trained
# tensor's move within this share (L2) of the one process's move, by
# compute dtype (TF32 off).  The grid sums fc7's partial products, the
# crops' gradient and the gradients in other orders, and its convolutions
# run at 4 images where the one process's run at 8; in bfloat16 each
# rank's fc7 partial product is rounded to bfloat16 before the float32
# sum, where one product is rounded once.
GRID_MOVE_RTOL = {"float32": 1e-2, "bfloat16": 1e-1}
# losses (and grad_norm) in bfloat16: each relative to one process's (the
# first entry where the trunk gives the same bits at 4 images as at 8,
# the second elsewhere, as DP_RTOL)
GRID_BF16_RTOL = (1e-2, 1e-2)


@contextlib.contextmanager
def collectives(records: list, mesh):
    """Time every ``all_reduce`` (synchronised on the card before and
    after): (axis, bytes, ms) per call, the axis "data" or "model" by the
    mesh's group it runs over."""
    import torch
    import torch.distributed as dist

    real = dist.all_reduce

    def timed(t, *args, group=None, **kw):
        sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = real(t, *args, group=group, **kw)
        sync()
        axis = "data" if group is mesh.data else "model" if group is mesh.model else "other"
        records.append((axis, t.numel() * t.element_size(), (time.perf_counter() - t0) * 1e3))
        return out

    dist.all_reduce = timed
    try:
        yield records
    finally:
        dist.all_reduce = real


def by_axis(records) -> dict:
    """{axis: [calls, bytes, ms]} of :func:`collectives`' records."""
    out = {}
    for axis, nb, ms in records:
        c = out.setdefault(axis, [0, 0, 0.0])
        c[0], c[1], c[2] = c[0] + 1, c[1] + nb, c[2] + ms
    return out


def move_error(before, after, ref_after) -> float:
    """The largest share (L2) by which a trained tensor's move in the grid
    step differs from one process's move from the same ``before``; frozen
    tensors must not move on either side."""
    import torch

    from trcnn_torch.train.optim import is_frozen

    worst = 0.0
    for k, ref in ref_after.items():
        if is_frozen(k):
            if not (torch.equal(after[k], before[k]) and torch.equal(ref, before[k])):
                raise AssertionError(f"frozen {k} moved")
            continue
        want = ref - before[k]
        worst = max(worst, float((after[k] - before[k] - want).norm() / want.norm()))
    return worst


def grid_job(job, dev, rank, world, group):
    """A rank of the 2 x 2 grid.  (a) ``len(batches)`` steps (compute dtype
    ``job["dtype"]``, float32 master weights) on its data index's rows of the global batches of 8 from seeded weights (the
    other ranks start from other ones, which the state's broadcast
    overwrites), each step's collectives timed by axis; before each, every
    rank gathers the whole state and rank 0 takes one process's step from
    it on the whole batch (:func:`reference_step`), and after it rank 0
    holds the grid's moves against the one process's
    (:func:`move_error`).  Its launches and the replay of its kernel calls
    (the first of each input shape, every K1 call) through the plain
    versions.  (b) Given a ``ckpt_dir``: the whole state after (a) written
    by a 2 x 2 Trainer there (the device memory its ``save`` took on this
    rank beside this rank's fc6/fc7 blocks and momentum), restored by a
    1 x 4 Trainer (gathered back whole on every rank) and by a Trainer at
    world size 1 on rank 0: bit-equal or not, and the 1 x 4 fc6 block's
    shape."""
    import dataclasses

    import torch

    from trcnn_torch import _build, parallel
    from trcnn_torch.parallel.tensor import load_whole_, param_shardings, whole_state
    from trcnn_torch.train import trainer as trainer_mod
    from trcnn_torch.train.step import TrainState

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = config_from_dict(job["cfg"])
    n_data, n_model = job["grid"]
    dtype = getattr(torch, job["dtype"])
    mesh = parallel.make_mesh(n_data, n_model)
    model = dp_model(cfg, dev, dtype)
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    state = TrainState.create(model, mesh)
    kinds = param_shardings(model)
    replicated = {k for k, v in kinds.items() if v is None}
    res = {"mesh": (mesh.data_index, mesh.model_index),
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "sharded": {k: tuple(p.shape) for k, p in model.named_parameters() if kinds[k]}}
    ref = None
    if rank == 0:
        ref = TrainState.create(dp_model(cfg, dev, dtype), parallel.Mesh())
        res["whole_param_bytes"] = sum(p.numel() * p.element_size()
                                       for p in ref.model.parameters())
    batches = [{k: v.to(dev) for k, v in b.items()} for b in torch.load(job["batches"])]

    def gathered():
        """The whole state, copied (the state_dict holds the live tensors)."""
        return ({k: v.clone() for k, v in d.items()}
                for d in whole_state(state.model, state.optimizer.momentum))

    whole, momentum = gathered()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    refs, steps, comms, moves, captured = [], [], [], [], {}
    launches = dict.fromkeys(_build.launch_counts, 0)
    for batch in batches:
        if rank == 0:
            ref.model.load_state_dict(whole)
            ref.optimizer.load_state_dict({"momentum": momentum})
            ref.step = state.step
            refs.append(reference_step(ref, batch, n_data, keep_params=True))
        sync()
        before = dict(_build.launch_counts)
        with recording(captured, first_of_shape=True), collectives([], mesh) as records:
            steps += run_steps(state, [rows(batch, mesh.data_index, n_data)])
        sync()
        for k in launches:
            launches[k] += _build.launch_counts[k] - before[k]
        steps[-1]["replicated"] = digest(state.model, names=replicated)
        comms.append(by_axis(records))
        after, momentum = gathered()
        if rank == 0:
            moves.append(move_error(whole, after, refs[-1].pop("params")))
        whole = after
    res.update(steps=steps, refs=refs, comms=comms, moves=moves, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0)
    # the last step's collectives again, all ranks in step (a barrier first),
    # one axis at a time: their cost without the wait for the slowest rank
    alone = {}
    for axis in ("data", "model"):
        bufs = [torch.zeros(nb // 4, device=dev) for a, nb, _ in records if a == axis]
        times = []
        for _ in range(3):
            parallel.barrier(group)
            sync()
            t0 = time.perf_counter()
            for b in bufs:
                torch.distributed.all_reduce(b, group=getattr(mesh, axis))
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        alone[axis] = statistics.median(times)
    res["alone_ms"] = alone
    res["replay"] = replay(captured, f"grid rank {rank}'s {job['dtype']} steps")
    del captured, state, ref, model, batches
    if not job.get("ckpt_dir"):
        return res

    d = job["ckpt_dir"]
    tcfg = trainer_mod.TrainConfig(checkpoint_every=0, checkpoint_dir=d)
    trainer_mod.make_mesh = lambda: parallel.make_mesh(n_data, n_model)
    t = trainer_mod.Trainer(dp_model(cfg, dev, torch.float32), cfg, tcfg, device=dev)
    load_whole_(t.state.model, t.state.optimizer, whole, momentum)
    t.state.step = len(steps)
    # the device memory the save takes on this rank, beside its own fc6/fc7
    # blocks and their momentum
    own = 2 * sum(nbytes(p) for k, p in t.state.model.named_parameters() if kinds[k])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    t.save()
    sync()
    res["save"] = {"rise": (torch.cuda.max_memory_allocated() - base) if cuda else 0,
                   "own_blocks": own, "ms": (time.perf_counter() - t0) * 1e3}
    del t
    restored = {}
    for what, grid in (("1 x 4", (1, world)), ("world 1", None)):
        if grid is None and rank:
            continue
        if grid is not None:
            trainer_mod.make_mesh = lambda: parallel.make_mesh(*grid)
        t = trainer_mod.Trainer(dp_model(cfg, dev, torch.float32), cfg, dataclasses.replace(
            tcfg, use_mesh=grid is not None), device=dev)
        sd, mom = whole_state(t.state.model, t.state.optimizer.momentum)
        restored[what] = {
            "step": t.state.step, "mesh": t.mesh.shape,
            "fc6": tuple(t.state.model.head.fc6.weight.shape),
            "equal": all(torch.equal(sd[k], v) for k, v in whole.items())
            and all(torch.equal(mom[k], v) for k, v in momentum.items())}
        del t, sd, mom
    res["restored"] = restored
    return res


def phase_grid(dev, by_path, tmp, dtype: str = "float32", n_steps: int = 3):
    """fc6/fc7 tensor parallelism at full width: four gloo ranks on a
    2 x 2 (data, model) grid share the card, VGG-16 VOC in ``dtype`` with
    float32 master weights (fc6 25088 x 4096 cut into two blocks of rows,
    fc7 into two of columns), global batch 8 (4 images per data index),
    ``n_steps`` steps, each against one process's step from the same state
    (:func:`grid_job`): the sampled sets equal, losses within DP_RTOL and
    grad_norm within DP_NORM_RTOL (bfloat16: GRID_BF16_RTOL), each trained
    tensor's move within GRID_MOVE_RTOL of the one process's, the replicas
    of one model index bit-identical and every replicated parameter
    bit-identical on the four ranks; each rank launching exactly the path's
    kernels and replaying its kernel calls through the plain versions.
    Prints each rank's parameter bytes, the collectives' calls, bytes and
    time per step by axis, peak memory.  In float32, then the save and the
    restore: the state written by the 2 x 2 Trainer, whose save must take
    less device memory on ranks 1-3 than their own fc6/fc7 blocks and
    momentum (only rank 0 gathers them whole), restored bit-equal at 1 x 4
    (fc6 in four blocks) and at world size 1."""
    import os

    import torch

    cfg = dp_config("voc", "vgg16")
    job = {"name": f"vgg16_grid_train_{dtype}", "kind": "grid", "cfg": cfg, "dtype": dtype,
           "device": dev.type, "world": GRID[0] * GRID[1], "grid": list(GRID),
           "batches": os.path.join(tmp, f"grid_batches_{dtype}.pt")}
    if dtype == "float32":
        job["ckpt_dir"] = os.path.join(tmp, "grid_ckpt")
    rtol = DP_RTOL if dtype == "float32" else GRID_BF16_RTOL
    torch.save(dp_global_batches(cfg, False, n_steps), job["batches"])
    t0 = time.perf_counter()
    ranks = launch_ranks(job, tmp)
    secs = time.perf_counter() - t0
    what = f"tensor parallel VGG-16 VOC train, {dtype}, a {GRID[0]} x {GRID[1]} grid of gloo ranks"
    if [r["mesh"] for r in ranks] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        raise AssertionError(f"{what}: ranks at {[r['mesh'] for r in ranks]}")
    whole = cfg.head_hidden
    want = {"head.fc6.weight": (whole // GRID[1], 7 * 7 * 512),
            "head.fc7.weight": (whole, whole // GRID[1])}
    if any(r["sharded"] != want for r in ranks):
        raise AssertionError(f"{what}: blocks {[r['sharded'] for r in ranks]}, not {want}")
    ref = ranks[0]["refs"]
    for i, want_ in enumerate(ref):
        got = ranks[0]["steps"][i]["metrics"]
        phase(f"  step {i + 1}, rank 0 (one process): " + ", ".join(
            f"{k} {got[k]:.6g} ({v:.6g})" for k, v in want_["metrics"].items()))
    for i in range(n_steps):
        s = [r["steps"][i] for r in ranks]
        if s[1]["digest"] != s[3]["digest"] or len({x["replicated"] for x in s}) != 1:
            raise AssertionError(f"{what}: the replicas differ after step {i + 1}")
        for a, b in ((0, 1), (2, 3)):
            if any(not torch.equal(v, s[b]["sampled"][k]) for k, v in s[a]["sampled"].items()):
                raise AssertionError(f"{what}: model ranks {a} and {b} sampled differently at "
                                     f"step {i + 1}")
        if any(x["metrics"] != s[0]["metrics"] for x in s):
            raise AssertionError(f"{what}: the ranks report different metrics at step {i + 1}")
    compare_steps(ref, [ranks[0]["steps"], ranks[2]["steps"]], what, rtol)
    worst = max(abs(s["metrics"][k] - v) / abs(v) for r, s in zip(ref, ranks[0]["steps"])
                for k, v in r["metrics"].items() if v)
    moves = ranks[0]["moves"]
    if max(moves) > GRID_MOVE_RTOL[dtype]:
        raise AssertionError(f"{what}: a move {max(moves):.3e} off one process's")
    path = "vgg16 grid train"
    for r, res in enumerate(ranks):
        require_launches(path, res["launches"])
        by_path[f"{path} {dtype} rank {r}"] = res["launches"]
    same = [i + 1 for i, r in enumerate(ref) if r["same_trunk"]]
    phase(f"{what}, {n_steps} steps at a global batch of 8, each vs one process from the "
          f"same state, {secs:.1f} s: fc6 and fc7 blocks {want}; parameters per rank "
          f"{ranks[0]['param_bytes'] / 2**20:.1f} MiB against "
          f"{ranks[0]['whole_param_bytes'] / 2**20:.1f} MiB whole; anchors and sampled RoIs "
          f"equal, the trunk's bits at 4 images equal those at 8 at steps {same}; losses and "
          f"grad_norm within {worst:.2e} of one process's (limits {rtol}, grad_norm at least "
          f"{DP_NORM_RTOL:g}); each trained tensor's move within "
          f"{', '.join(f'{m:.2e}' for m in moves)} of one process's (L2, limit "
          f"{GRID_MOVE_RTOL[dtype]:g}); replicas of a model index and every replicated parameter "
          f"bit-identical on the four ranks, the model ranks of a data index sampling alike")
    for r, res in enumerate(ranks):
        per_step = "; ".join(
            ", ".join(f"{axis} {c[0]} calls {c[1] / 2**20:.1f} MiB {c[2]:.2f} ms"
                      for axis, c in sorted(step.items()))
            for step in res["comms"])
        phase(f"  rank {r} collectives per step (host clock, synchronised; the first of each "
              f"axis waits for the slowest rank): {per_step}; the last step's again with the "
              f"ranks in step: data {res['alone_ms']['data']:.2f} ms, model "
              f"{res['alone_ms']['model']:.2f} ms; step ms "
              f"{[round(x['ms'], 2) for x in res['steps']]}; peak {res['peak_gib']:.2f} GiB")
    for res in ranks:
        phase(f"  {res['replay']}")
    phase(f"  one process's step ms {[round(x['ms'], 2) for x in ref]}; launches per rank "
          f"{ranks[0]['launches']}")
    if dtype != "float32":
        return
    restored = [r["restored"] for r in ranks]
    want_fc6 = (whole // (GRID[0] * GRID[1]), 7 * 7 * 512)
    if not all(r["1 x 4"]["equal"] and r["1 x 4"]["fc6"] == want_fc6
               and r["1 x 4"]["step"] == n_steps for r in restored):
        raise AssertionError(f"grid restore at 1 x 4: {restored}")
    alone = restored[0]["world 1"]
    if not (alone["equal"] and alone["step"] == n_steps and alone["mesh"] == {"data": 1,
                                                                                "model": 1}):
        raise AssertionError(f"grid restore at world size 1: {alone}")
    saves = [r["save"] for r in ranks]
    if any(x["rise"] >= x["own_blocks"] for x in saves[1:]):
        raise AssertionError(f"grid save: a non-writing rank's device memory rose by more than "
                             f"its own fc6/fc7 blocks and momentum: {saves}")
    phase("grid save (fc6/fc7 and momentum gathered to rank 0 alone, through host memory): "
          "device memory rise over Trainer.save per rank " + ", ".join(
              f"{r} {x['rise'] / 2**20:.1f} MiB ({x['ms']:.0f} ms)" for r, x in enumerate(saves))
          + f"; limit on ranks 1-3: their own blocks and momentum, "
          f"{saves[1]['own_blocks'] / 2**20:.1f} MiB (when every rank gathered the whole "
          f"state for a save: 4.90 GiB peak on the non-writing ranks, H100 80GB HBM3, 700 W)")
    phase(f"grid restore: the state after the grid steps written by the 2 x 2 Trainer "
          f"({sorted(os.listdir(job['ckpt_dir']))}), restored at 1 x 4 (fc6 blocks {want_fc6} on "
          f"each of the 4 ranks) and at world size 1: parameters and momentum bit-equal")


def phase_dryrun(dev):
    """``trcnn_torch.entry.dryrun_multichip(4)`` on the card: a 2 x 2 grid
    of gloo processes, one step of the tiny config, JAX's assertions."""
    import io

    from trcnn_torch.entry import dryrun_multichip

    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        m = dryrun_multichip(4, device=dev.type)
    secs = time.perf_counter() - t0
    log_file("dp.txt", f"$ dryrun_multichip(4)\n{text.getvalue()}")
    phase(f"dryrun_multichip(4) on the card, {secs:.1f} s: "
          + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))



# ------------------------------------------------- align paths in turns


def turn_profile(run, n: int) -> dict:
    """``run`` n times under torch.profiler: the device's busy share of the
    host-clock time of the n calls, and kernel ms per call by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("the profiler saw no device time")
    busy, span = kernel_union(kernels)
    groups = kernel_split(kernels, n)[0]
    return {"busy_of_wall_pct": busy / wall_us * 100, "busy_of_span_pct": busy / span * 100,
            "kernel_ms": {k: round(v, 4) for k, v in sorted(groups.items())}}


def turn_path(dev, call, request=None, n: int = 8) -> dict:
    """One path of a turn: the median host-clock ms of ``n`` calls (and of
    ``request``'s, if given), the profile of 3 calls, the peak device
    memory over all of them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"ms": host_ms(call, n)}
    if request is not None:
        out["request_ms"] = host_ms(request, n)
    out.update(turn_profile(call, 3))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def align_turn(root: str) -> dict:
    """The four align paths of the ``trcnn_torch`` package under ``root``
    (VGG-16 VOC detect and train, R101 COCO detect and train, bf16, the
    seeds of :func:`phase_slice`, :func:`phase_train`,
    :func:`phase_coco_detect` and :func:`phase_coco_train`), each
    :func:`turn_path`."""
    import torch

    import trcnn_torch
    from trcnn_torch.config import voc_config
    from trcnn_torch.data import DetectionLoader, SyntheticDetection
    from trcnn_torch.entry import entry, train_entry
    from trcnn_torch.train.step import device_batch

    pkg = Path(trcnn_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise AssertionError(f"imported trcnn_torch from {pkg}, not from {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {}

    cfg = with_mode(voc_config(), "align")
    fn, (model, image, im_info) = entry(dev, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    request = torch.randint(0, 256, image.shape, dtype=torch.uint8, generator=gen, device=dev)
    images8 = torch.randint(0, 256, (8,) + image.shape[1:], dtype=torch.uint8, generator=gen,
                            device=dev)
    im_info8 = im_info.expand(8, 3).contiguous()
    check_dets(fn(model, images8, im_info8), 8)
    res["VGG-16 VOC align detect b=8"] = turn_path(
        dev, lambda: fn(model, images8, im_info8), lambda: fn(model, request, im_info))
    del model, fn
    torch.cuda.empty_cache()

    step_fn, (state, batch) = train_entry(dev, cfg=cfg)
    check_step(step_fn(state, batch), 0)
    res["VGG-16 VOC align train b=8"] = turn_path(dev, lambda: step_fn(state, batch), n=6)
    del state, step_fn
    torch.cuda.empty_cache()

    cfg = coco_cfg("resnet101", "align")
    fn, (model, image, im_info) = entry(dev, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(8)
    images8 = torch.randint(0, 256, (8,) + image.shape[1:], dtype=torch.uint8, generator=gen,
                            device=dev)
    im_info8 = im_info.expand(8, 3).contiguous()
    calibrate(model, images8[:2], im_info8[:2], head=True)
    check_dets(fn(model, images8, im_info8), 8)
    res["R101 COCO align detect b=8"] = turn_path(
        dev, lambda: fn(model, images8, im_info8), lambda: fn(model, image, im_info), n=5)
    del model, fn
    torch.cuda.empty_cache()

    step_fn, (state, _) = train_entry(dev, cfg=cfg)
    loader = DetectionLoader(SyntheticDetection(n=16, num_classes=cfg.num_classes, seed=5),
                             batch_size=8, image_cfg=cfg.image, augment=True, shuffle=True,
                             seed=1, uint8_images=True)
    batch = [device_batch(b, dev) for b in loader][1]
    check_step(step_fn(state, batch), 0)
    res["R101 COCO align train b=8"] = turn_path(dev, lambda: step_fn(state, batch), n=5)
    del state, step_fn
    torch.cuda.empty_cache()
    return res


def align_turns_main(parent: str) -> int:
    """``chip_smoke.py --align-turns PARENT``: the four align paths of the
    tree at PARENT (an unpacked checkout) and of this script's tree, in
    turns (parent, this, this, parent), each turn a process of its own
    (``--align-turn ROOT``) on the card; prints each path's numbers by turn
    as a table and, last, all of them as one JSON line."""
    here = str(Path(__file__).resolve().parent)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    phase(f"align paths in turns on {card}: parent {parent}, this tree {here}")
    turns = []
    for who, root in (("parent", parent), ("this", here), ("this", here),
                      ("parent", parent)):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, __file__, "--align-turn", root],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        if run.returncode != 0 or not lines:
            print(run.stdout[-4000:] + run.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"the {who} turn failed (exit {run.returncode})")
        turns.append({"tree": who, "seconds": round(time.perf_counter() - t0, 1),
                      "paths": json.loads(lines[-1])})
        phase(f"  turn {len(turns)} ({who}) done in {turns[-1]['seconds']} s")
    for path in turns[0]["paths"]:
        phase(f"{path}:")
        for i, t in enumerate(turns):
            r = t["paths"][path]
            phase(f"  turn {i + 1} {t['tree']:6s} {r['ms']:.2f} ms"
                  + (f", request {r['request_ms']:.2f} ms" if "request_ms" in r else "")
                  + f", busy {r['busy_of_wall_pct']:.1f}% of the host clock "
                  f"({r['busy_of_span_pct']:.1f}% of the device span), peak "
                  f"{r['peak_gib']:.2f} GiB; kernels "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sorted(r["kernel_ms"].items(),
                                                                key=lambda kv: -kv[1])))
    print(json.dumps({"card": card, "turns": turns}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--align-turn"]:
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        import torch

        print(json.dumps(align_turn(sys.argv[2])))
        return 0
    import torch

    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank_main(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--align-turns"]:
        return align_turns_main(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    from trcnn_torch import _build

    start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_card()
    phase_build()
    rec = phase_kernels(dev)
    for backbone in BACKBONES:
        phase_small_parity(dev, backbone)
        phase_train_parity(dev, backbone)
    by_path = {}
    for backbone in BACKBONES:
        by_path[f"{backbone} detect"] = phase_slice(dev, backbone, rec)
        by_path[f"{backbone} train"] = phase_train(dev, backbone, rec)
    for backbone in BACKBONES:
        phase_capture(dev, backbone)
    phase_r1_cost(dev)
    phase_large_map(dev, by_path)
    with tempfile.TemporaryDirectory() as tmp:
        phase("data path: VOC config, seeded weights, the CLIs' own code on the card")
        npz, sd = phase_weights(dev, tmp)
        phase_eval(dev, by_path, npz, tmp)
        phase_train_cli(dev, by_path, npz, sd, tmp)
        phase_forward_cli(dev, by_path, npz, tmp)
        phase_convert(npz, tmp)
        phase_parity(dev, by_path, npz, tmp)
    phase_train_steps(dev, by_path)
    phase_preprocess_device(dev, by_path)
    phase_coco_kernels(dev, rec)
    for backbone in BACKBONES:
        by_path[f"{backbone} coco detect"] = phase_coco_detect(dev, backbone, rec)
        by_path[f"{backbone} coco train"] = phase_coco_train(dev, backbone, rec)
    with tempfile.TemporaryDirectory() as tmp:
        phase_coco_eval(dev, by_path, tmp)
    # the two opt-in model modes: RoIAlign (K5, K6) and int8
    phase_align_kernels(dev, rec)
    for backbone in BACKBONES:
        phase_small_parity(dev, backbone, "align")
    phase_int8_small(dev)
    by_path["vgg16 align detect"] = phase_slice(dev, "vgg16", rec, "align")
    by_path["vgg16 align train"] = phase_train(dev, "vgg16", rec, "align")
    by_path["resnet101 coco align detect"] = phase_coco_detect(dev, "resnet101", rec, "align")
    by_path["resnet101 coco align train"] = phase_coco_train(dev, "resnet101", rec, "align")
    phase_int8(dev, by_path)
    # data parallelism: two gloo ranks share the card; NCCL at world size 1
    phase_dp_small(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_dp_train(dev, by_path, tmp, "voc", "vgg16", 3)
        phase_dp_train(dev, by_path, tmp, "coco", "resnet101", 2)
        phase_dp_eval(dev, by_path, tmp)
        phase_nccl_cli(dev, by_path, tmp)
    # tensor parallelism: four gloo ranks on a 2 x 2 grid share the card
    with tempfile.TemporaryDirectory() as tmp:
        phase_grid(dev, by_path, tmp)
        phase_grid(dev, by_path, tmp, "bfloat16", 1)
    phase_dryrun(dev)
    phase(f"chip_smoke.py: {time.perf_counter() - start:.1f} s")
    phase(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1],
                    launches=sum(p[name] for p in by_path.values()),
                    launches_by_path={k: p[name] for k, p in by_path.items()}, **rec[name])
               for name in _build.COUNTERS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
