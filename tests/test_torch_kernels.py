"""Kernels K1-K6 against their plain PyTorch versions on the card, and the
int8 products of the int8 mode against the CPU.

These need a CUDA device and the CUDA toolkit; without a card they skip.
The file imports no JAX, so on the card it runs without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Shapes are small and ragged (canvases that are not multiples of the stem's
tile, box counts that are not multiples of 64, batches with an image that
has no valid box) so that every edge path of the kernels runs;
chip_smoke.py checks the main path's full shapes.  The small configs of
both backbones run through the port on the card against the CPU's plain
path by chip_smoke's own phases, so the two agree on what they check.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from trcnn_torch.ops import nms, quant, roi_align, roi_pool, stem
from trcnn_torch.utils.profiling import counters

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("n,t,max_out,n_groups", [
    (1, 0.7, 4, 0), (63, 0.7, 10, 0), (130, 0.5, 200, 0), (700, 0.3, 100, 7),
    (2000, 0.7, 300, 0)])
def test_nms_kernel_matches_plain(dev, n, t, max_out, n_groups):
    rng = np.random.default_rng(n)
    c = rng.uniform(0, 300, (n, 2))
    s = rng.uniform(4, 60, (n, 2))
    boxes = torch.tensor(np.concatenate([c - s / 2, c + s / 2], 1), dtype=torch.float32)
    scores = torch.tensor(np.round(rng.uniform(0, 1, n), 2), dtype=torch.float32)
    valid = torch.tensor(rng.uniform(0, 1, n) > 0.1)
    groups = (torch.tensor(rng.integers(0, n_groups, n), dtype=torch.int32)
              if n_groups else None)
    order = torch.sort(-torch.where(valid, scores, -torch.inf), stable=True).indices
    args = [boxes[order], valid[order], None if groups is None else groups[order]]
    args = [None if a is None else a.to(dev).contiguous() for a in args]
    before = counters["launch.nms"]
    kp, kv = nms.greedy_keep_cuda(args[0], args[1], t, max_out, args[2])
    assert counters["launch.nms"] == before + 1
    pp, pv = nms.greedy_keep_plain(args[0], args[1], t, max_out, args[2])
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kp, pp)
    # the dispatcher routes CUDA tensors to the kernel, and the full
    # nms_padded path agrees with the CPU plain path
    gi, gv = nms.nms_padded(boxes.to(dev), scores.to(dev), valid.to(dev), t, max_out,
                            groups=None if groups is None else groups.to(dev))
    ci, cv = nms.nms_padded(boxes, scores, valid, t, max_out, groups=groups)
    assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)


def _sorted_nms_batch(rng, b, n, n_groups):
    """(B, N) score-sorted boxes; image 1 (when B > 1) has no valid box."""
    c = rng.uniform(0, 300, (b, n, 2))
    s = rng.uniform(4, 60, (b, n, 2))
    boxes = torch.tensor(np.concatenate([c - s / 2, c + s / 2], -1), dtype=torch.float32)
    scores = torch.tensor(np.round(rng.uniform(0, 1, (b, n)), 2), dtype=torch.float32)
    valid = torch.tensor(rng.uniform(0, 1, (b, n)) > 0.1)
    if b > 1:
        valid[1] = False
    groups = (torch.tensor(rng.integers(0, n_groups, (b, n)), dtype=torch.int32)
              if n_groups else None)
    order = torch.sort(-torch.where(valid, scores, -torch.inf), dim=1, stable=True).indices
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(valid, 1, order),
            None if groups is None else torch.gather(groups, 1, order))


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("n,t,max_out,n_groups", [
    (200, 0.7, 300, 0), (1000, 0.7, 100, 0), (1300, 0.3, 100, 20)])
def test_batched_nms_kernel_matches_plain(dev, b, n, t, max_out, n_groups):
    """One K1 launch for the batch equals the plain version per image, an
    image with no valid box and one with fewer survivors than max_out
    among them."""
    boxes, valid, groups = _sorted_nms_batch(np.random.default_rng(b * n), b, n, n_groups)
    args = [None if a is None else a.to(dev).contiguous() for a in (boxes, valid, groups)]
    before = counters["launch.nms"]
    kp, kv = nms.greedy_keep_cuda(args[0], args[1], t, max_out, args[2])
    assert counters["launch.nms"] == before + 1
    assert kp.shape == (b, max_out) and kv.shape == (b, max_out)
    pp, pv = nms.greedy_keep_plain(args[0], args[1], t, max_out, args[2])
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kp, pp)
    if b > 1:
        assert not kv[1].any()
    if max_out == 300:
        assert 0 < int(kv[0].sum()) < max_out


def _unaligned(t):
    """A contiguous copy of ``t`` whose base is one element past a 16-byte
    boundary: the kernels then take their one-element-per-item path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,r,h,w,c", [(1, 5, 7, 9, 3), (2, 37, 21, 30, 40),
                                       (3, 64, 38, 64, 512), (2, 29, 38, 64, 1024),
                                       (2, 23, 50, 84, 48)])
def test_roi_pool_kernel_bit_equal(dev, dtype, b, r, h, w, c):
    """K2 at P=7 and P=14: the VGG map, the R101-C4 width (C=1024), the
    COCO map (50 x 84), ragged channel counts (3, 40) and an unaligned
    base."""
    rng = np.random.default_rng(r)
    x1 = rng.uniform(-60, w * 16 + 30, (b, r))
    y1 = rng.uniform(-60, h * 16 + 30, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, w * 20, (b, r)),
                     y1 + rng.uniform(0, h * 20, (b, r))], -1).astype(np.float32)
    feat = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=dtype, device=dev)
    rois_t = torch.tensor(rois, device=dev)
    for p in (7, 14):
        want = roi_pool.roi_max_pool_plain(feat, rois_t, p, 1 / 16)
        for f in (feat, _unaligned(feat)):
            k = roi_pool.roi_max_pool_cuda(f, rois_t, p, 1 / 16)
            assert torch.equal(_bits(k), _bits(want))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b,r,h,w,c,p", [(1, 5, 7, 9, 3, 7), (2, 37, 21, 30, 48, 7),
                                         (3, 61, 38, 64, 512, 7), (2, 29, 38, 64, 1024, 14),
                                         (2, 23, 50, 84, 48, 7), (1, 19, 100, 90, 24, 7),
                                         (1, 300, 21, 30, 48, 14)])
def test_roi_pool_backward_kernel(dev, dtype, ties, b, r, h, w, c, p):
    """K4: bit-equal to the plain version with integer-valued gradients
    (every float32 sum exact in any order), the winners included when the
    map is tie-heavy; within rounding with real-valued gradients (float32:
    1e-5 of the largest |dfeat|; bf16: one bf16 ulp of it).  RoIs larger
    than the map and beyond it (empty bins).  Shapes: P=14 at the R101-C4
    width (C=1024); the COCO map (50 x 84), whose slab takes 8 channels a
    block; a 100 x 90 map, which splits into two row bands with bins that
    straddle the edge; 300 RoIs at P=14, more than one chunk of RoI ranges
    in a block's shared memory; ragged channel counts (3, 24, 48) and an
    unaligned base."""
    rng = np.random.default_rng(r + c)
    x1 = rng.uniform(-60, w * 16 + 30, (b, r))
    y1 = rng.uniform(-60, h * 16 + 30, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, w * 20, (b, r)),
                     y1 + rng.uniform(0, h * 20, (b, r))], -1).astype(np.float32)
    rois[:, 0] = (w * 16 + 50, 0, w * 16 + 90, 40)
    feat = (rng.integers(0, 3, (b, h, w, c)) if ties else rng.standard_normal((b, h, w, c)))
    feat = torch.tensor(feat, dtype=dtype, device=dev)
    rois_t = torch.tensor(rois, device=dev)
    g_int = torch.tensor(rng.integers(-4, 5, (b, r, p, p, c)), dtype=dtype, device=dev)
    want = roi_pool.roi_pool_backward_plain(feat, rois_t, g_int, p)
    for f, gi in ((feat, g_int), (_unaligned(feat), _unaligned(g_int))):
        before = counters["launch.roi_pool_bwd"]
        k = roi_pool.roi_pool_backward_cuda(f, rois_t, gi, p)
        assert counters["launch.roi_pool_bwd"] == before + 1
        assert k.dtype == dtype and torch.equal(_bits(k), _bits(want))
    g = torch.tensor(rng.standard_normal((b, r, p, p, c)), dtype=dtype, device=dev)
    k = roi_pool.roi_pool_backward_cuda(feat, rois_t, g, p).float()
    want = roi_pool.roi_pool_backward_plain(feat, rois_t, g, p).float()
    scale = float(want.abs().max())
    limit = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    assert float((k - want).abs().max()) <= limit
    # autograd through roi_max_pool reaches K2 and K4
    x = feat.clone().requires_grad_()
    roi_pool.roi_max_pool(x, rois_t, p).backward(g_int)
    assert torch.equal(_bits(x.grad), _bits(roi_pool.roi_pool_backward_plain(feat, rois_t, g_int, p)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b,r,h,w,c", [(2, 61, 300, 90, 512), (2, 61, 90, 300, 512),
                                       (1, 23, 300, 90, 24), (1, 23, 257, 40, 3)])
def test_roi_pool_backward_large_map_kernel(dev, dtype, ties, b, r, h, w, c):
    """K4's large-map variant (maps over 255 cells on a side: feat walked
    from global memory, 16-bit cell coordinates): bit-equal to the plain
    version with integer-valued gradients, on a tie-heavy map too, tall and
    wide, in several row bands (the 300 x 90 maps); ragged channel
    counts (24, 3) and an unaligned base take one channel an item.  Within
    rounding on real-valued g."""
    plan = roi_pool._bwd_plan(h, w, torch.empty((), dtype=dtype).element_size())
    assert plan.large and (h * w != 27000 or -(-h // plan.band_rows) > 1)
    rng = np.random.default_rng(r + c + h)
    x1 = rng.uniform(-60, w * 16 + 30, (b, r))
    y1 = rng.uniform(-60, h * 16 + 30, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, w * 12, (b, r)),
                     y1 + rng.uniform(0, h * 12, (b, r))], -1).astype(np.float32)
    rois[:, 0] = (0, 0, w * 16 - 1, h * 16 - 1)                  # the whole map
    feat = (rng.integers(0, 3, (b, h, w, c)) if ties else rng.standard_normal((b, h, w, c)))
    feat = torch.tensor(feat, dtype=dtype, device=dev)
    rois_t = torch.tensor(rois, device=dev)
    g_int = torch.tensor(rng.integers(-4, 5, (b, r, 7, 7, c)), dtype=dtype, device=dev)
    want = roi_pool.roi_pool_backward_plain(feat, rois_t, g_int)
    for f, gi in ((feat, g_int), (_unaligned(feat), _unaligned(g_int))):
        before = counters.copy()
        k = roi_pool.roi_pool_backward_cuda(f, rois_t, gi)
        assert counters["launch.roi_pool_bwd_large"] == before["launch.roi_pool_bwd_large"] + 1
        assert counters["launch.roi_pool_bwd"] == before["launch.roi_pool_bwd"]
        assert k.dtype == dtype and torch.equal(_bits(k), _bits(want))
    g = torch.tensor(rng.standard_normal((b, r, 7, 7, c)), dtype=dtype, device=dev)
    k = roi_pool.roi_pool_backward_cuda(feat, rois_t, g).float()
    want = roi_pool.roi_pool_backward_plain(feat, rois_t, g).float()
    scale = float(want.abs().max())
    limit = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    assert float((k - want).abs().max()) <= limit


def _stem_args(rng, shape, integer, dev, dtype):
    if integer:
        vals = (rng.integers(-8, 9, shape), rng.integers(-2, 3, (64, 3, 3, 3)),
                rng.integers(-4, 5, 64), rng.integers(-2, 3, (64, 64, 3, 3)) / 16.0,
                rng.integers(-4, 5, 64))
    else:
        vals = (rng.standard_normal(shape) * 20, rng.standard_normal((64, 3, 3, 3)) * 0.2,
                rng.standard_normal(64) * 0.1, rng.standard_normal((64, 64, 3, 3)) * 0.04,
                rng.standard_normal(64) * 0.1)
    return [torch.tensor(np.asarray(v), dtype=dtype, device=dev) for v in vals]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 2, 3), (2, 10, 34, 3), (1, 30, 18, 3),
                                   (1, 64, 96, 3), (3, 38, 70, 3), (1, 18, 130, 3)])
def test_stem_kernel_exact_on_integer_inputs(dev, dtype, shape):
    """Integer-valued inputs make every convolution sum exact in float32 in
    any order, so the kernel must be bit-equal to the plain version: this
    pins indexing, halos, ragged tiles, rounding order and the pool."""
    args = _stem_args(np.random.default_rng(0), shape, True, dev, dtype)
    k = stem.stem_block1_cuda(*args)
    want = stem.stem_block1_plain(*args)
    assert k.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    assert torch.equal(_bits(k), _bits(want))


@pytest.mark.parametrize("shape", [(2, 10, 34, 3), (1, 64, 96, 3)])
def test_stem_kernel_f32_tolerance(dev, shape):
    args = _stem_args(np.random.default_rng(1), shape, False, dev, torch.float32)
    k = stem.stem_block1_cuda(*args)
    want = stem.stem_block1_plain(*args)
    assert float((k - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("shape", [(3, 38, 70, 3), (1, 64, 96, 3), (2, 18, 130, 3)])
def test_stem_kernel_bf16_tolerance(dev, shape):
    """Real-valued bf16 inputs on canvases that are not multiples of the
    tile (8 x 64 conv outputs): within one bf16 ulp of the output scale."""
    args = _stem_args(np.random.default_rng(2), shape, False, dev, torch.bfloat16)
    k = stem.stem_block1_cuda(*args).float()
    want = stem.stem_block1_plain(*args).float()
    assert float((k - want).abs().max()) <= _bf16_ulp(float(want.abs().max()))


def _chip_smoke():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("backbone", ["vgg16", "resnet101"])
def test_small_config_detect_matches_cpu(dev, backbone):
    """chip_smoke's small-config phase: float32 detections on the card
    (kernels) equal to the CPU's (plain versions) on the same weights;
    ResNet-101 with live residual branches and random FrozenBN leaves."""
    _chip_smoke().phase_small_parity(dev, backbone)


@pytest.mark.parametrize("backbone", ["vgg16", "resnet101"])
def test_small_config_training_step_matches_cpu(dev, backbone):
    """chip_smoke's small-config training phase: one training forward with
    the CPU's sampling draws (decisions and losses), then one step
    (gradients and updated parameters) on the card against the CPU."""
    _chip_smoke().phase_train_parity(dev, backbone)


def test_two_gloo_ranks_on_the_card_equal_one_process(dev):
    """chip_smoke's small data-parallel phase: two gloo ranks sharing the
    card (one image each, the head's dropout on) take two float32 training
    steps, each equal to one process's step from the same state on the same
    global batch of two: the replicas bit-identical, the sampled sets
    equal, losses and grad_norm within chip_smoke.DP_RTOL and
    DP_NORM_RTOL."""
    _chip_smoke().phase_dp_small(dev)


@pytest.mark.parametrize("b", [1, 2])
def test_nms_kernel_at_the_coco_epilogue(dev, b):
    """K1 at the COCO epilogue's width: 80 classes x 1000 RoIs = 80,000
    grouped pairs per image, every pair valid in image 0 (the whole
    triangle of 1250 x 1251 / 2 = 781,875 block pairs), image 1 a short
    prefix; nms_padded's trimmed suppression equal to the plain version on
    the same prefix and to the untrimmed kernel call."""
    rng = np.random.default_rng(80 + b)
    r, fg = 1000, 80
    c = rng.uniform(0, 1300, (b, r, 2))
    s = rng.uniform(16, 300, (b, r, 2))
    rois = np.concatenate([c - s / 2, c + s / 2], -1)
    boxes = rois[:, None] + rng.normal(0, 3, (b, fg, r, 4))
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2])
    boxes = torch.tensor(boxes.reshape(b, fg * r, 4), dtype=torch.float32, device=dev)
    scores = torch.tensor(np.round(rng.uniform(0.06, 1, (b, fg * r)), 2), dtype=torch.float32,
                          device=dev)
    valid = torch.ones((b, fg * r), dtype=torch.bool, device=dev)
    if b > 1:
        valid[1] = torch.tensor(rng.uniform(0, 1, fg * r) < 0.05, device=dev)
    groups = torch.arange(fg, dtype=torch.int32, device=dev).repeat_interleave(r).expand(b, -1)
    groups = groups.contiguous()
    captured = []
    real = nms.greedy_keep_cuda

    def record(*args):
        captured.append(args)
        return real(*args)

    nms.greedy_keep_cuda = record
    try:
        ki, kv = nms.nms_padded(boxes, scores, valid, 0.3, 100, groups=groups)
    finally:
        nms.greedy_keep_cuda = real
    (sb, sv, t, max_out, sg), = captured
    assert sb.shape[1] == fg * r                       # image 0: every pair valid
    pp, pv = nms.greedy_keep_plain(sb, sv, t, max_out, sg)
    kp, kv2 = real(sb, sv, t, max_out, sg)
    torch.cuda.synchronize()
    assert torch.equal(kp, pp) and torch.equal(kv2, pv)
    assert int(kv[0].sum()) == 100
    if b > 1:
        # the short image alone is trimmed to its prefix: the same result
        oi, ov = nms.nms_padded(boxes[1:], scores[1:], valid[1:], 0.3, 100, groups=groups[1:])
        assert torch.equal(oi[0], ki[1]) and torch.equal(ov[0], kv[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,c", [(7, 512), (14, 1024)])
def test_roi_pool_kernels_on_the_coco_map(dev, dtype, p, c):
    """K2 and K4 on the COCO config's 50 x 84 map (and its portrait
    transpose) at the VGG-16 and ResNet-101-C4 pools: bit-equal to the plain
    versions, K4 with integer-valued gradients (exact sums in any order);
    f32 takes K4's plan of 4 channels a block."""
    for h, w in ((50, 84), (84, 50)):
        rng = np.random.default_rng(p + c + h)
        b, r = 2, 64
        x1 = rng.uniform(-60, w * 16 + 30, (b, r))
        y1 = rng.uniform(-60, h * 16 + 30, (b, r))
        rois = np.stack([x1, y1, x1 + rng.uniform(0, w * 20, (b, r)),
                         y1 + rng.uniform(0, h * 20, (b, r))], -1).astype(np.float32)
        feat = torch.tensor(rng.integers(-8, 9, (b, h, w, c)), dtype=dtype, device=dev)
        rois_t = torch.tensor(rois, device=dev)
        k = roi_pool.roi_max_pool_cuda(feat, rois_t, p, 1 / 16)
        assert torch.equal(_bits(k), _bits(roi_pool.roi_max_pool_plain(feat, rois_t, p, 1 / 16)))
        g = torch.tensor(rng.integers(-4, 5, (b, r, p, p, c)), dtype=dtype, device=dev)
        assert not roi_pool._bwd_plan(h, w, feat.element_size()).large
        k = roi_pool.roi_pool_backward_cuda(feat, rois_t, g, p)
        assert torch.equal(_bits(k), _bits(roi_pool.roi_pool_backward_plain(feat, rois_t, g, p)))


@pytest.mark.parametrize("shape", [(2, 800, 1344, 3), (1, 1344, 800, 3)])
def test_stem_kernel_on_the_coco_canvas(dev, shape):
    """K3 on the COCO config's 800 x 1344 canvas and its portrait
    transpose: bit-equal to the plain version on integer inputs, in f32
    and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _stem_args(np.random.default_rng(3), shape, True, dev, dtype)
        assert torch.equal(_bits(stem.stem_block1_cuda(*args)),
                           _bits(stem.stem_block1_plain(*args)))


def _align_rois(rng, b, r, h, w):
    """Random RoIs, plus one beyond the map (every sample clipped to the
    last cell), one over the whole map and past it, one under one cell and
    one of zero size."""
    x1 = rng.uniform(-60, w * 16 + 30, (b, r))
    y1 = rng.uniform(-60, h * 16 + 30, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, w * 20, (b, r)),
                     y1 + rng.uniform(0, h * 20, (b, r))], -1)
    rois[:, 0] = (w * 16 + 50, h * 16 + 20, w * 16 + 90, h * 16 + 60)
    rois[:, 1] = (-100, -80, w * 16 + 100, h * 16 + 90)
    rois[:, 2] = (37, 21, 45, 25)
    rois[:, 3] = (80, 48, 80, 48)
    return rois.astype(np.float32)


ALIGN_SHAPES = [(1, 5, 7, 9, 3, 7), (2, 37, 21, 30, 40, 7), (2, 29, 38, 64, 512, 7),
                (2, 23, 50, 84, 1024, 14), (1, 9, 84, 50, 24, 14), (1, 11, 21, 30, 768, 7),
                (1, 13, 17, 25, 520, 14)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,r,h,w,c,p", ALIGN_SHAPES)
def test_roi_align_kernel_bit_equal(dev, dtype, out_dtype, b, r, h, w, c, p):
    """K5: bit-equal to the plain version (the same float32 operations in
    the same order, none contracted; a bfloat16 output the float32 mean
    rounded once), at P=7 and P=14, the VGG and R101 widths, the COCO map
    and its transpose, ragged channel counts (3, 40, 24) and an unaligned
    base; edge-clipped and sub-cell RoIs."""
    rng = np.random.default_rng(r + c)
    feat = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=dtype, device=dev)
    rois = torch.tensor(_align_rois(rng, b, r, h, w), device=dev)
    want = roi_align.roi_align_plain(feat, rois, p, out_dtype=out_dtype)
    assert torch.equal(_bits(want),
                       _bits(roi_align.roi_align_plain(feat, rois, p).to(out_dtype)))
    for f in (feat, _unaligned(feat)):
        before = counters["launch.roi_align"]
        k = roi_align.roi_align_cuda(f, rois, p, out_dtype=out_dtype)
        assert counters["launch.roi_align"] == before + 1
        assert k.dtype == out_dtype and torch.equal(_bits(k), _bits(want))


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,r,h,w,c,p", ALIGN_SHAPES)
def test_roi_align_backward_kernel(dev, dtype, g_dtype, b, r, h, w, c, p):
    """K6 within rounding of the plain version: float32 within 1e-5 of the
    largest |dfeat|, bf16 within one bf16 ulp of it (K6 merges a bin's
    samples per cell and sums in another order), for float32 and bfloat16
    g; two calls on the same inputs bit-identical (each dfeat element is
    summed by one thread in a fixed order); autograd through roi_align
    with a g_dtype output reaches K5 and K6, and the RoIs get no
    gradient."""
    rng = np.random.default_rng(r + c + 1)
    feat = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=dtype, device=dev)
    rois = torch.tensor(_align_rois(rng, b, r, h, w), device=dev)
    g = torch.tensor(rng.standard_normal((b, r, p, p, c)), dtype=g_dtype, device=dev)
    want = roi_align.roi_align_backward_plain(feat.shape, dtype, rois, g, p).float()
    scale = float(want.abs().max())
    limit = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    for gi in (g, _unaligned(g)):
        before = counters["launch.roi_align_bwd"]
        k = roi_align.roi_align_backward_cuda(feat.shape, dtype, rois, gi, p)
        assert counters["launch.roi_align_bwd"] == before + 1
        assert k.dtype == dtype
        assert float((k.float() - want).abs().max()) <= limit
        again = roi_align.roi_align_backward_cuda(feat.shape, dtype, rois, gi, p)
        assert torch.equal(_bits(again), _bits(k))
    x = feat.clone().requires_grad_()
    r_t = rois.clone().requires_grad_()
    before = counters.copy()
    out = roi_align.roi_align(x, r_t, p, out_dtype=g_dtype)
    assert out.dtype == g_dtype
    out.backward(g)
    assert counters["launch.roi_align"] == before["launch.roi_align"] + 1
    assert counters["launch.roi_align_bwd"] == before["launch.roi_align_bwd"] + 1
    assert r_t.grad is None and x.grad.dtype == dtype
    assert float((x.grad.float() - want).abs().max()) <= limit


@pytest.mark.parametrize("m,k,n", [(2 * 38 * 64, 576, 128), (300, 25088, 64), (5, 37, 21),
                                   (17, 8, 8)])
def test_int8_product_on_the_card_equals_the_cpu(dev, m, k, n):
    """The int8 products (cuBLASLt's int8 GEMM) are exact in int32: equal to
    the CPU's, padded where cuBLASLt takes M > 16 and K, N multiples of 8;
    qdense and qconv2d equal to the CPU's bit for bit."""
    rng = np.random.default_rng(m + k)
    a = torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (n, k)), dtype=torch.int8)
    assert torch.equal(quant.int8_matmul(a.to(dev), b.to(dev)).cpu(), quant.int8_matmul(a, b))
    x = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    lin = torch.nn.Linear(k, n)
    lin_d = torch.nn.Linear(k, n, device=dev)
    lin_d.load_state_dict(lin.state_dict())
    with torch.no_grad():
        assert torch.equal(quant.qdense(x.to(dev), lin_d).cpu(), quant.qdense(x, lin))
    conv = torch.nn.Conv2d(13, 24, 3, padding=1)
    conv_d = torch.nn.Conv2d(13, 24, 3, padding=1, device=dev)
    conv_d.load_state_dict(conv.state_dict())
    xc = torch.tensor(rng.standard_normal((2, 9, 11, 13)), dtype=torch.float32)
    with torch.no_grad():
        assert torch.equal(quant.qconv2d(xc.to(dev), conv_d).cpu(), quant.qconv2d(xc, conv))
