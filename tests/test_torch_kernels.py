"""Kernels K1-K4 against their plain PyTorch versions on the card.

These need a CUDA device and the CUDA toolkit; without a card they skip.
The file imports no JAX, so on the card it runs without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Shapes are small and ragged (canvases that are not multiples of the stem's
tile, box counts that are not multiples of 64) so that every edge path of
the kernels runs; chip_smoke.py checks the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from trcnn_torch import _build
from trcnn_torch.ops import nms, roi_pool, stem

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
    before = _build.launch_counts["nms"]
    kp, kv = nms.greedy_keep_cuda(args[0], args[1], t, max_out, args[2])
    assert _build.launch_counts["nms"] == before + 1
    pp, pv = nms.greedy_keep_plain(args[0], args[1], t, max_out, args[2])
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kp, pp)
    # the dispatcher routes CUDA tensors to the kernel, and the full
    # nms_padded path agrees with the CPU plain path
    gi, gv = nms.nms_padded(boxes.to(dev), scores.to(dev), valid.to(dev), t, max_out,
                            groups=None if groups is None else groups.to(dev))
    ci, cv = nms.nms_padded(boxes, scores, valid, t, max_out, groups=groups)
    assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,r,h,w,c", [(1, 5, 7, 9, 3), (2, 37, 21, 30, 40),
                                       (3, 64, 38, 64, 512)])
def test_roi_pool_kernel_bit_equal(dev, dtype, b, r, h, w, c):
    rng = np.random.default_rng(r)
    x1 = rng.uniform(-60, w * 16 + 30, (b, r))
    y1 = rng.uniform(-60, h * 16 + 30, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, w * 20, (b, r)),
                     y1 + rng.uniform(0, h * 20, (b, r))], -1).astype(np.float32)
    feat = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=dtype, device=dev)
    rois_t = torch.tensor(rois, device=dev)
    for p in (7, 14):
        k = roi_pool.roi_max_pool_cuda(feat, rois_t, p, 1 / 16)
        want = roi_pool.roi_max_pool_plain(feat, rois_t, p, 1 / 16)
        assert torch.equal(_bits(k), _bits(want))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b,r,h,w,c", [(1, 5, 7, 9, 3), (2, 37, 21, 30, 48),
                                       (3, 61, 38, 64, 512)])
def test_roi_pool_backward_kernel(dev, dtype, ties, b, r, h, w, c):
    """K4: bit-equal to the plain version with integer-valued gradients
    (every float32 sum exact in any order), the winners included when the
    map is tie-heavy; within rounding with real-valued gradients (float32:
    1e-5 of the largest |dfeat|; bf16: one bf16 ulp of it).  RoIs larger
    than the map and beyond it (empty bins)."""
    rng = np.random.default_rng(r + c)
    x1 = rng.uniform(-60, w * 16 + 30, (b, r))
    y1 = rng.uniform(-60, h * 16 + 30, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, w * 20, (b, r)),
                     y1 + rng.uniform(0, h * 20, (b, r))], -1).astype(np.float32)
    rois[:, 0] = (w * 16 + 50, 0, w * 16 + 90, 40)
    feat = (rng.integers(0, 3, (b, h, w, c)) if ties else rng.standard_normal((b, h, w, c)))
    feat = torch.tensor(feat, dtype=dtype, device=dev)
    rois_t = torch.tensor(rois, device=dev)
    g_int = torch.tensor(rng.integers(-4, 5, (b, r, 7, 7, c)), dtype=dtype, device=dev)
    before = _build.launch_counts["roi_pool_bwd"]
    k = roi_pool.roi_pool_backward_cuda(feat, rois_t, g_int)
    assert _build.launch_counts["roi_pool_bwd"] == before + 1
    want = roi_pool.roi_pool_backward_plain(feat, rois_t, g_int)
    assert k.dtype == dtype and torch.equal(_bits(k), _bits(want))
    g = torch.tensor(rng.standard_normal((b, r, 7, 7, c)), dtype=dtype, device=dev)
    k = roi_pool.roi_pool_backward_cuda(feat, rois_t, g).float()
    want = roi_pool.roi_pool_backward_plain(feat, rois_t, g).float()
    scale = float(want.abs().max())
    limit = 1e-5 * scale if dtype == torch.float32 else _bf16_ulp(scale)
    assert float((k - want).abs().max()) <= limit
    # autograd through roi_max_pool reaches K2 and K4
    x = feat.clone().requires_grad_()
    roi_pool.roi_max_pool(x, rois_t).backward(g_int)
    assert torch.equal(_bits(x.grad), _bits(roi_pool.roi_pool_backward_plain(feat, rois_t, g_int)))


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
                                   (1, 64, 96, 3)])
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
