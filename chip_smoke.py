#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``trcnn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels K1-K4 from ``trcnn_torch/csrc``, all at once;
3. each kernel against its plain PyTorch version on the card at the main
   paths' shapes, with both times (CUDA events, median after warm-up) and
   the least time the card could take (``bound_ms``, from this run's
   inputs);
4. a small config through the port on the card and on the CPU (plain
   versions) with the same weights: the detections must agree, and one
   training forward with the same sampling draws must make the same
   sampling decisions and losses;
5. the two main paths at full width, VGG-16 VOC, seeded weights, bf16 with
   float32 master weights, uint8 608x1024 canvases, each with the launch
   counters set to 0 before it and read after it:
   - detect, through ``trcnn_torch.entry.entry``: three one-image requests
     and one batch of 8; K1-K3 must move;
   - train, through ``trcnn_torch.entry.train_entry``: one cold step and 6
     timed steps at batch 8; K1-K4 must move;
6. one float32 request and one float32 train step whose kernel inputs are
   captured and replayed through the plain versions.

The next-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# kernel -> (csrc source, TPU kernel it replaces)
KERNELS = {
    "nms": ("trcnn_torch/csrc/nms.cu", "trcnn/ops/nms_pallas.py:216"),
    "roi_pool": ("trcnn_torch/csrc/roi_pool.cu", "trcnn/ops/roi_pool_pallas.py:451"),
    "roi_pool_bwd": ("trcnn_torch/csrc/roi_pool_bwd.cu", "trcnn/ops/roi_pool_pallas.py:571"),
    "stem": ("trcnn_torch/csrc/stem.cu", "trcnn/ops/stem_pallas.py:226"),
}
# kernels each main path must launch
REQUIRED = {"detect": ("nms", "roi_pool", "stem"),
            "train": ("nms", "roi_pool", "roi_pool_bwd", "stem")}
STEM_F32_RTOL = 1e-4
ROI_BWD_F32_RTOL = 1e-5
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
    """Median device time of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def sorted_nms_inputs(boxes, scores, valid, groups, dev):
    """Score-sort on the device (stable), as nms_padded does."""
    import torch

    b = torch.from_numpy(boxes).to(dev)
    sc = torch.where(torch.from_numpy(valid).to(dev), torch.from_numpy(scores).to(dev),
                     torch.tensor(float("-inf"), device=dev))
    neg, order = torch.sort(-sc, stable=True)
    g = None if groups is None else torch.from_numpy(groups).to(dev)[order].contiguous()
    return b[order].contiguous(), (-neg > float("-inf")).contiguous(), g


def check_nms_equal(args, thresh, max_out, what):
    from trcnn_torch.ops import nms

    kp, kv = nms.greedy_keep_cuda(*args[:2], thresh, max_out, args[2])
    pp, pv = nms.greedy_keep_plain(*args[:2], thresh, max_out, args[2])
    # both put index 0 in padding slots, so equal outputs are equal keep-sets
    mism = int((kp != pp).sum()) + int((kv != pv).sum())
    if mism:
        raise AssertionError(f"K1 keep-set differs from the plain version: {what}")
    phase(f"  K1 {what}: kept {int(kv.sum())}, keep-set equal")
    return float(mism)


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


def check_roi_equal(feat, rois, what):
    import torch

    from trcnn_torch.ops import roi_pool

    k = roi_pool.roi_max_pool_cuda(feat, rois)
    p = roi_pool.roi_max_pool_plain(feat, rois)
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
        ok = float(err.max()) <= STEM_F32_RTOL * scale
        phase(f"  K3 {what}: max abs err {float(err.max()):.3e} "
              f"(limit {STEM_F32_RTOL} x {scale:.3e})")
    else:
        limit = float(bf16_ulp(torch.tensor(scale)))
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


def check_roi_bwd(feat, rois, g, what, exact):
    """exact: bit-equal (integer-valued g: every float32 sum is exact in any
    order, so the winners and the sums must agree).  Otherwise float32
    within ROI_BWD_F32_RTOL of the largest |dfeat|, bf16 within one bf16
    ulp of it (the atomics add in another order)."""
    import torch

    from trcnn_torch.ops import roi_pool

    k = roi_pool.roi_pool_backward_cuda(feat, rois, g)
    p = roi_pool.roi_pool_backward_plain(feat, rois, g)
    err = float((k.float() - p.float()).abs().max())
    scale = float(p.float().abs().max())
    if exact:
        ok = torch.equal(bits(k), bits(p))
        phase(f"  K4 {what}: {'bit-equal' if ok else 'NOT bit-equal'}, max abs err {err:.3e}")
    else:
        limit = (ROI_BWD_F32_RTOL * scale if feat.dtype == torch.float32
                 else float(bf16_ulp(torch.tensor(scale))))
        ok = err <= limit
        phase(f"  K4 {what}: max abs err {err:.3e} (limit {limit:.3e} at scale {scale:.3e})")
    if not ok:
        raise AssertionError(f"K4 disagrees with the plain version: {what}")
    return err


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

    # K1: proposals 6000 -> 300 @0.7 (presorted), epilogue 20 x 300 -> 100
    # @0.3 (grouped, sorted here), train 12000 -> 2000 @0.7
    err = 0.0
    cases = [("6000->300 @0.7", nms_case(6000, 1), 0.7, 300),
             ("grouped 20x300->100 @0.3", epilogue_case(20, 300, 2), 0.3, 100),
             ("12000->2000 @0.7", nms_case(12000, 3), 0.7, 2000)]
    timed = []
    for what, case, t, k in cases:
        args = sorted_nms_inputs(*case, dev)
        err = max(err, check_nms_equal(args, t, k, what))
        timed.append((args, t, k))
    # the train path's shape, timed apart (the record keeps the detect shape)
    args, t, k = timed[2]
    ms = cuda_time_ms(lambda: nms.greedy_keep_cuda(args[0], args[1], t, k, args[2]))
    phase(f"  K1 time at 12000->2000 (train): kernel {ms:.4f} ms")
    args, t, k = timed[0]
    ms = cuda_time_ms(lambda: nms.greedy_keep_cuda(args[0], args[1], t, k, args[2]))
    plain_ms = cuda_time_ms(lambda: nms.greedy_keep_plain(args[0], args[1], t, k, args[2]))
    # the greedy pass needs each kept box's predicate against every later box
    # (about 12 float32 operations each); bytes: boxes and flags in, keep out
    pos, kv = nms.greedy_keep_cuda(args[0], args[1], t, k, args[2])
    n = args[0].shape[0]
    pairs = int((n - 1 - pos[kv].long()).sum())
    b1 = bound(nbytes(args[0], args[1], args[2], pos, kv), 12.0 * pairs, F32_OPS)
    phase(f"  K1 time at 6000->300: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b1['bound_ms']:.4f} ms ({b1['bound_by']}, {pairs} predicates)")
    rec["nms"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b1)

    # K2: B=1 and B=8 x 300 RoIs on the VGG map (38 x 64 x 512), bf16 and f32
    err = 0.0
    for b in (1, 8):
        feat, rois = roi_case(b, 300, 10 + b)
        rois_t = torch.from_numpy(rois).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            feat_t = torch.from_numpy(feat).to(dev, dt)
            err = max(err, check_roi_equal(feat_t, rois_t, f"B={b} {dt}"))
    feat_t = torch.from_numpy(feat).to(dev, torch.bfloat16)
    ms = cuda_time_ms(lambda: roi_pool.roi_max_pool_cuda(feat_t, rois_t))
    plain_ms = cuda_time_ms(lambda: roi_pool.roi_max_pool_plain(feat_t, rois_t))
    cells, _ = bin_cells(rois_t, 38, 64)
    out_bytes = rois_t.shape[0] * rois_t.shape[1] * 49 * 512 * feat_t.element_size()
    b2 = bound(nbytes(feat_t, rois_t) + out_bytes, cells * 512.0, F32_OPS)
    phase(f"  K2 time at B=8 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b2['bound_ms']:.4f} ms ({b2['bound_by']})")
    rec["roi_pool"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b2)

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
            rec["roi_pool"]["max_abs_err"] = max(rec["roi_pool"]["max_abs_err"], check_roi_equal(
                torch.from_numpy(f).to(dev, dt), rois_t, f"B=8x128 {dt}{what} (train)"))
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for what, f, g, exact in (("integer g", feat, g_int, True),
                                  ("integer g, tie-heavy map", ties, g_int, True),
                                  ("real g", feat, g_real, False)):
            feat_t = torch.from_numpy(f).to(dev, dt)
            g_t = torch.from_numpy(g).to(dev, dt)
            err = max(err, check_roi_bwd(feat_t, rois_t, g_t, f"B=8x128 {dt} {what}", exact))
    ms = cuda_time_ms(lambda: roi_pool.roi_pool_backward_cuda(feat_t, rois_t, g_t))
    plain_ms = cuda_time_ms(lambda: roi_pool.roi_pool_backward_plain(feat_t, rois_t, g_t),
                            warmup=1, iters=5)
    cells, bins = bin_cells(rois_t, 38, 64)
    b4 = bound(nbytes(feat_t, rois_t, g_t, feat_t), (cells + bins) * 512.0, F32_OPS)
    phase(f"  K4 time at B=8x128 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b4['bound_ms']:.4f} ms ({b4['bound_by']})")
    rec["roi_pool_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b4)

    # K3: the full canvas, integer-valued (exact) and real-valued: one image
    # in f32 and bf16 (a request), a batch of 8 in bf16 (detect b=8, train)
    err = 0.0
    for integer in (True, False):
        args8 = [torch.from_numpy(a).to(dev, torch.bfloat16)
                 for a in stem_case((8, 608, 1024, 3), 21, integer=integer)]
        err = max(err, check_stem(args8, f"(8,608,1024,3) {torch.bfloat16} "
                                         f"{'integer' if integer else 'real'}", exact=integer))
        case = stem_case((1, 608, 1024, 3), 20, integer=integer)
        for dt in (torch.float32, torch.bfloat16):
            args = [torch.from_numpy(a).to(dev, dt) for a in case]
            err = max(err, check_stem(args, f"(1,608,1024,3) {dt} "
                                            f"{'integer' if integer else 'real'}",
                                      exact=integer))
    # the batch's shape, timed apart (the record keeps the request's shape)
    ms = cuda_time_ms(lambda: stem.stem_block1_cuda(*args8), iters=5)
    phase(f"  K3 time at (8,608,1024,3) bf16 (detect b=8, train): kernel {ms:.4f} ms")
    del args8
    ms = cuda_time_ms(lambda: stem.stem_block1_cuda(*args))
    plain_ms = cuda_time_ms(lambda: stem.stem_block1_plain(*args))
    hw = 608 * 1024
    b3 = bound(nbytes(*args) + hw // 4 * 64 * 2, 2.0 * hw * 64 * (27 + 576), BF16_OPS)
    phase(f"  K3 time at (1,608,1024,3) bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b3['bound_ms']:.4f} ms ({b3['bound_by']})")
    rec["stem"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b3)
    return rec


def phase_small_parity(dev):
    """The golden test's config through the port on the card and on the CPU
    with the same seeded weights, float32."""
    import torch

    from trcnn_torch.config import FasterRCNNConfig, ProposalConfig
    from trcnn_torch.models import make_model, postprocess

    cfg = FasterRCNNConfig(head_hidden=32, rpn_channels=16,
                           proposals=ProposalConfig(pre_nms_topk_test=192,
                                                    post_nms_topk_test=24))
    cpu = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(42)).eval()
    gpu = make_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(42)
    images = torch.from_numpy(rng.uniform(0, 256, (2, 64, 96, 3)).astype(np.uint8))
    info = torch.tensor([[60.0, 90.0, 1.2], [64.0, 80.0, 1.0]])
    with torch.no_grad():
        ref_raw = cpu.detect(images, info)
        ref = postprocess(ref_raw, info, cfg, score_thresh=0.02)
        raw = gpu.detect(images.to(dev), info.to(dev))
        got = postprocess(raw, info.to(dev), cfg, score_thresh=0.02)
    got_raw = [t.cpu() for t in raw]
    got = [t.cpu() for t in got]
    if not torch.equal(got_raw[1], ref_raw.roi_valid):
        raise AssertionError("small config: roi_valid differs between card and CPU")
    torch.testing.assert_close(got_raw[0], ref_raw.rois, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got_raw[2], ref_raw.cls_prob, rtol=1e-4, atol=1e-5)
    if not (torch.equal(got[3], ref.valid) and torch.equal(got[2], ref.classes)):
        raise AssertionError("small config: detections differ between card and CPU")
    torch.testing.assert_close(got[0], ref.boxes, rtol=1e-3, atol=1e-2)
    phase(f"small config: card == CPU plain path, {int(ref.valid.sum())} detections")


def train_cfg():
    """The small training config of tests/test_cross_impl_train.py."""
    from trcnn_torch.config import (AnchorConfig, FasterRCNNConfig, ImageConfig,
                                    ProposalConfig, ProposalTargetConfig)

    return FasterRCNNConfig(
        head_hidden=64, rpn_channels=64, head_dropout=0.0,
        anchors=AnchorConfig(scales=(2.0, 4.0, 8.0)),
        proposals=ProposalConfig(pre_nms_topk_train=512, post_nms_topk_train=64,
                                 pre_nms_topk_test=512, post_nms_topk_test=64),
        proposal_targets=ProposalTargetConfig(rois_per_image=16),
        image=ImageConfig(pad_h=128, pad_w=192))


def train_proposals(model, images, im_info):
    """The proposals ``losses`` samples from, through the model's own
    ``propose``."""
    import torch

    with torch.no_grad():
        rpn = model.rpn(model.extractor(model._prepare(images, im_info)))
        return model.propose(rpn, im_info, train=True)


def phase_train_parity(dev):
    """One training forward of the small config on the card and on the CPU
    (plain versions), float32, the same weights and the same sampling draws
    (drawn on the CPU: a CUDA generator gives other numbers).  Anchor-target
    decisions and sample counts must be equal, the losses within 1e-4."""
    import torch

    from trcnn_torch.models import make_model
    from trcnn_torch.ops.anchors import shifted_anchors
    from trcnn_torch.targets import anchor_targets

    cfg = train_cfg()
    cpu = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    images = torch.from_numpy((rng.standard_normal((2, 128, 192, 3)) * 40).astype(np.float32))
    info = torch.tensor([[120.0, 180.0, 1.2], [100.0, 160.0, 1.0]])
    gtb = torch.zeros((2, 4, 4))
    gtb[0, :3] = torch.tensor([[10, 12, 70, 60], [90, 30, 170, 100], [40, 70, 110, 115.0]])
    gtb[1, :2] = torch.tensor([[20, 15, 95, 80], [100, 40, 150, 95.0]])
    gtl = torch.tensor([[3, 7, 12, 0], [5, 18, 0, 0]], dtype=torch.int32)
    gtv = torch.tensor([[True, True, True, False], [True, True, False, False]])
    # spread the RPN scores (a 0.01-sigma init is tie-dominated), as the
    # JAX fixture does
    with torch.no_grad():
        rpn = cpu.rpn(cpu.extractor(images))
        cpu.rpn.rpn_cls_score.weight.mul_(2.0 / float(rpn.logits.std()))
        cpu.rpn.rpn_bbox_pred.weight.mul_(0.15 / float(rpn.deltas.std()))
    gpu = make_model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    uni = cpu.draw_uniforms(2, (8, 12), 4, torch.Generator().manual_seed(4))
    args = (images, info, gtb, gtl, gtv)
    on_dev = lambda ts: [t.to(dev) for t in ts]  # noqa: E731

    anchors = shifted_anchors(8, 12, cfg.anchors)
    at_c = anchor_targets(anchors, gtb, gtv, info[:, 0], info[:, 1], uni["at_fg"],
                          uni["at_bg"], cfg.anchor_targets)
    at_g = anchor_targets(*on_dev((anchors, gtb, gtv, info[:, 0], info[:, 1], uni["at_fg"],
                                   uni["at_bg"])), cfg.anchor_targets)
    if not (torch.equal(at_g.labels.cpu(), at_c.labels)
            and torch.equal(at_g.num_fg.cpu(), at_c.num_fg)):
        raise AssertionError("small config: anchor-target decisions differ")

    gpu_uni = {k: v.to(dev) for k, v in uni.items()}
    with torch.no_grad():
        ref = cpu.losses(*args, generator=torch.Generator(), uniforms=uni)
        got = gpu.losses(*on_dev(args), generator=torch.Generator(device=dev), uniforms=gpu_uni)
    props_c = train_proposals(cpu, images, info)
    props_g = [t.cpu() for t in train_proposals(gpu, *on_dev((images, info)))]
    same = torch.equal(props_g[1], props_c[1]) and torch.allclose(props_g[0], props_c[0],
                                                                   rtol=1e-5, atol=1e-3)
    if not same:
        phase("  small config: the card's proposals differ from the CPU's (a score "
              "rounds differently); losses compared on the CPU's proposals")
        with torch.no_grad():
            got = gpu.losses(*on_dev(args), generator=torch.Generator(device=dev),
                             uniforms=gpu_uni, proposals=on_dev(props_c))
    for k in ("num_fg_anchors", "num_fg_rois"):
        if float(got[k]) != float(ref[k]):
            raise AssertionError(f"small config: {k} {float(got[k])} vs CPU {float(ref[k])}")
    worst = 0.0
    for k in ("loss", "rpn_cls_loss", "rpn_bbox_loss", "cls_loss", "bbox_loss"):
        rel = abs(float(got[k]) - float(ref[k])) / abs(float(ref[k]))
        worst = max(worst, rel)
        if rel > 1e-4:
            raise AssertionError(f"small config: {k} {float(got[k])} vs CPU {float(ref[k])}")
    phase(f"small config training: card == CPU plain path, proposals "
          f"{'equal' if same else 'differ'}, fg anchors {float(ref['num_fg_anchors'])}, "
          f"fg rois {float(ref['num_fg_rois'])}, losses within {worst:.2e} relative")


# kernel-name fragments -> what they are, for the profile's breakdown
KERNEL_GROUPS = (("trcnn_nms", "K1 nms"), ("roi_pool_fwd", "K2 roi_pool"),
                 ("roi_pool_bwd", "K4 roi_pool_bwd"), ("stem_", "K3 stem"),
                 ("gemm", "matmul/conv"), ("conv", "matmul/conv"), ("xmma", "matmul/conv"),
                 ("cutlass", "matmul/conv"), ("nvjet", "matmul/conv"), ("cudnn", "matmul/conv"))


def profile_window(run, n, what, stages=()):
    """``run`` n times under torch.profiler: device kernel time per call by
    group, the largest other kernels, and the device's busy share (the union
    of kernel intervals over the span from the first kernel's start to the
    last one's end).  ``stages`` names profiler spans that ``run`` opens;
    each one's kernel time is printed (:func:`phase_split`).  Prints "no
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
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    span = max(e for _, e in spans) - spans[0][0]
    groups, other = {}, {}
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) / 1e3 / n
        g = next((label for frag, label in KERNEL_GROUPS if frag in e.name.lower()), None)
        if g is None:
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + t
            g = "other"
        groups[g] = groups.get(g, 0.0) + t
    phase(f"  profile {what}, {n} calls: device span {span / 1e3 / n:.3f} ms per call, busy "
          f"{busy / span * 100:.1f}%; kernel ms per call: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    phase("    largest other kernels: " + "; ".join(f"{k} {v:.3f}" for k, v in top))
    if stages:
        phase_split(events, stages, n, sum(groups.values()))


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
    missing = [k for k in REQUIRED[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {path} path never launched {missing}")


def phase_slice(dev):
    import torch

    from trcnn_torch import _build
    from trcnn_torch.entry import entry

    t0 = time.perf_counter()
    fn, (model, image, im_info) = entry(dev)
    torch.cuda.synchronize()
    phase(f"slice: VOC VGG-16 bf16, head_hidden {model.cfg.head_hidden}, built in "
          f"{time.perf_counter() - t0:.1f} s")
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
    require_launches("detect", launches)

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
    del model
    return launches


def check_step(m, step):
    import torch

    vals = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"step {step}: non-finite metrics {vals}")
    if not (vals["rpn_bbox_loss"] > 0 and vals["bbox_loss"] > 0 and vals["num_fg_rois"] > 0):
        raise AssertionError(f"step {step}: degenerate losses {vals}")
    return vals


def phase_train(dev):
    """The full-width training step through train_entry: one cold step, 6
    timed ones; the parameters move after the first, the frozen ones never;
    then 3 profiled steps, split into the step's own forward / backward /
    optimizer spans."""
    import torch

    from trcnn_torch import _build
    from trcnn_torch.entry import train_entry
    from trcnn_torch.train.optim import is_frozen
    from trcnn_torch.train.step import STAGES

    t0 = time.perf_counter()
    step_fn, (state, batch) = train_entry(dev)
    torch.cuda.synchronize()
    model = state.model
    phase(f"train: VOC VGG-16 bf16 compute, f32 master weights, head_hidden "
          f"{model.cfg.head_hidden}, batch {batch['images'].shape[0]} uint8 "
          f"{tuple(batch['images'].shape[1:3])}, built in {time.perf_counter() - t0:.1f} s")
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
                if moved == is_frozen(k):
                    raise AssertionError(f"after step 1, {k} {'moved' if moved else 'did not move'}")
    launches = dict(_build.launch_counts)
    phase(f"  launches over 7 train steps: {launches}")
    require_launches("train", launches)
    for i, v in enumerate(logs):
        phase(f"  step {i}: " + ", ".join(f"{k} {x:.5g}" for k, x in v.items()))
    warm = statistics.median(times[1:])
    phase(f"  step ms: cold {times[0]:.2f}, warm {', '.join(f'{t:.2f}' for t in times[1:])}; "
          f"median {warm:.2f} ms, {batch['images'].shape[0] / warm * 1e3:.2f} img/s")
    phase(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    profile_window(lambda: step_fn(state, batch), 3, "train step b=8", STAGES)
    del model, state, before
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def recording(captured):
    """Wrap every kernel wrapper so that each call's inputs (cloned) and
    output land in ``captured[name]``."""
    import torch

    from trcnn_torch.ops import nms, roi_pool, stem

    targets = {"nms": (nms, "greedy_keep_cuda"), "roi_pool": (roi_pool, "roi_max_pool_cuda"),
               "roi_pool_bwd": (roi_pool, "roi_pool_backward_cuda"),
               "stem": (stem, "stem_block1_cuda")}
    originals = {}
    for key, (mod, name) in targets.items():
        orig = originals[key] = getattr(mod, name)

        def wrapped(*args, _orig=orig, _key=key):
            out = _orig(*args)
            captured.setdefault(_key, []).append(
                ([a.clone() if torch.is_tensor(a) else a for a in args], out))
            return out

        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for key, (mod, name) in targets.items():
            setattr(mod, name, originals[key])


def replay(captured, what):
    """Each captured call through its plain version: K1 equal, K2 bit-equal,
    K3 and K4 within their float32 tolerances."""
    import torch

    from trcnn_torch.ops import nms, roi_pool, stem

    for args, (kp, kv) in captured.get("nms", []):
        pp, pv = nms.greedy_keep_plain(*args)
        if not (torch.equal(kv, pv) and torch.equal(kp, pp)):
            raise AssertionError(f"K1 differs from plain on the {what}'s inputs")
    for args, out in captured.get("roi_pool", []):
        if not torch.equal(bits(out), bits(roi_pool.roi_max_pool_plain(*args))):
            raise AssertionError(f"K2 differs from plain on the {what}'s inputs")
    for args, out in captured.get("stem", []):
        p = stem.stem_block1_plain(*args)
        err = float((out - p).abs().max())
        if err > STEM_F32_RTOL * float(p.abs().max()):
            raise AssertionError(f"K3 differs from plain on the {what}'s inputs: {err}")
    worst = 0.0
    for args, out in captured.get("roi_pool_bwd", []):
        p = roi_pool.roi_pool_backward_plain(*args)
        err = float((out - p).abs().max())
        worst = max(worst, err / max(float(p.abs().max()), 1e-30))
        if err > ROI_BWD_F32_RTOL * float(p.abs().max()):
            raise AssertionError(f"K4 differs from plain on the {what}'s inputs: {err}")
    phase(f"f32 {what}: captured {', '.join(f'{k} x{len(v)}' for k, v in captured.items())};"
          f" plain replay agrees" + (f" (K4 within {worst:.2e} of the largest |dfeat|)"
                                     if "roi_pool_bwd" in captured else ""))


def phase_capture(dev):
    """One float32 request and one float32 train step (batch 2); each
    kernel's actual inputs are recorded and replayed through its plain
    version."""
    import torch

    from trcnn_torch.entry import entry, train_entry

    captured = {}
    with recording(captured):
        fn, (model, image, im_info) = entry(dev, dtype=torch.float32)
        dets = fn(model, image, im_info)
        torch.cuda.synchronize()
    check_dets(dets, 1)
    del model
    for key in REQUIRED["detect"]:
        if not captured.get(key):
            raise AssertionError(f"f32 request did not reach {key}")
    replay(captured, "request")

    captured = {}
    with recording(captured):
        step_fn, (state, batch) = train_entry(dev, dtype=torch.float32, batch_size=2)
        check_step(step_fn(state, batch), 0)
        torch.cuda.synchronize()
    del state
    for key in REQUIRED["train"]:
        if not captured.get(key):
            raise AssertionError(f"f32 train step did not reach {key}")
    replay(captured, "train step")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    from trcnn_torch import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_card()
    phase_build()
    rec = phase_kernels(dev)
    phase_small_parity(dev)
    phase_train_parity(dev)
    by_path = {"detect": phase_slice(dev), "train": phase_train(dev)}
    phase_capture(dev)
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1],
                    launches=sum(p[name] for p in by_path.values()),
                    launches_by_path={k: p[name] for k, p in by_path.items()}, **rec[name])
               for name in _build.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
