#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``trcnn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels K1-K3 from ``trcnn_torch/csrc``;
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes, with both times (CUDA events, median after warm-up);
4. a small config through the port on the card and on the CPU (plain
   versions) with the same weights: the detections must agree;
5. the full-width VGG-16 VOC slice through ``trcnn_torch.entry`` (seeded
   weights, bf16, uint8 608x1024 canvas): three one-image requests and one
   batch of 8, with the launch counters of all three kernels required to
   move; then one float32 request whose kernel inputs are captured and
   replayed through the plain versions.

The next-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

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
    "stem": ("trcnn_torch/csrc/stem.cu", "trcnn/ops/stem_pallas.py:226"),
}
STEM_F32_RTOL = 1e-4


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
    timed = None
    for what, case, t, k in cases:
        args = sorted_nms_inputs(*case, dev)
        err = max(err, check_nms_equal(args, t, k, what))
        if timed is None:
            timed = (args, t, k)
    args, t, k = timed
    ms = cuda_time_ms(lambda: nms.greedy_keep_cuda(args[0], args[1], t, k, args[2]))
    plain_ms = cuda_time_ms(lambda: nms.greedy_keep_plain(args[0], args[1], t, k, args[2]))
    phase(f"  K1 time at 6000->300: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rec["nms"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

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
    phase(f"  K2 time at B=8 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rec["roi_pool"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # K3: the full canvas, integer-valued (exact) and real-valued, f32 and bf16
    err = 0.0
    for integer in (True, False):
        case = stem_case((1, 608, 1024, 3), 20, integer=integer)
        for dt in (torch.float32, torch.bfloat16):
            args = [torch.from_numpy(a).to(dev, dt) for a in case]
            err = max(err, check_stem(args, f"(1,608,1024,3) {dt} "
                                            f"{'integer' if integer else 'real'}",
                                      exact=integer))
    ms = cuda_time_ms(lambda: stem.stem_block1_cuda(*args))
    plain_ms = cuda_time_ms(lambda: stem.stem_block1_plain(*args))
    phase(f"  K3 time at (1,608,1024,3) bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rec["stem"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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
    cpu = make_model(cfg).init(torch.Generator().manual_seed(42)).eval()
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

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
    phase(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    return launches


def phase_capture(dev):
    """One float32 request; each kernel's actual inputs are recorded and
    replayed through its plain version."""
    import torch

    from trcnn_torch.entry import entry
    from trcnn_torch.ops import nms, roi_pool, stem

    captured = {"nms": [], "roi_pool": [], "stem": []}
    originals = {}

    def recorder(mod, name, key):
        orig = getattr(mod, name)
        originals[(mod, name)] = orig

        def wrapped(*args):
            out = orig(*args)
            captured[key].append(([a.clone() if torch.is_tensor(a) else a for a in args], out))
            return out

        setattr(mod, name, wrapped)

    recorder(nms, "greedy_keep_cuda", "nms")
    recorder(roi_pool, "roi_max_pool_cuda", "roi_pool")
    recorder(stem, "stem_block1_cuda", "stem")
    try:
        fn, (model, image, im_info) = entry(dev, dtype=torch.float32)
        dets = fn(model, image, im_info)
        torch.cuda.synchronize()
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)
    check_dets(dets, 1)
    for key, calls in captured.items():
        if not calls:
            raise AssertionError(f"f32 request did not reach {key}")
    for args, (kp, kv) in captured["nms"]:
        pp, pv = nms.greedy_keep_plain(*args)
        if not (torch.equal(kv, pv) and torch.equal(kp, pp)):
            raise AssertionError("K1 differs from plain on the request's inputs")
    for args, out in captured["roi_pool"]:
        if not torch.equal(bits(out), bits(roi_pool.roi_max_pool_plain(*args))):
            raise AssertionError("K2 differs from plain on the request's inputs")
    for args, out in captured["stem"]:
        p = stem.stem_block1_plain(*args)
        err = float((out - p).abs().max())
        if err > STEM_F32_RTOL * float(p.abs().max()):
            raise AssertionError(f"K3 differs from plain on the request's inputs: {err}")
    phase(f"f32 request: captured {', '.join(f'{k} x{len(v)}' for k, v in captured.items())};"
          f" plain replay agrees")


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
    launches = phase_slice(dev)
    phase_capture(dev)
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name], **rec[name])
               for name in _build.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
