"""The port's ops (trcnn_torch.ops) against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both frameworks.  The JAX
side runs as its own CPU path does: nms_padded, vmap(roi_max_pool) and
stem_block1_reference are the specs the CPU backend takes.  On CPU tensors
the port's NMS, RoI pool and stem run their plain PyTorch versions, the
versions kernels K1-K3 are held against on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trcnn.config import AnchorConfig, FasterRCNNConfig, ProposalConfig
from trcnn.models import make_model as jax_make_model
from trcnn.ops.anchors import generate_base_anchors as jax_base_anchors
from trcnn.ops.anchors import shifted_anchors as jax_shifted_anchors
from trcnn.ops.boxes import bbox_transform_inv as jax_decode
from trcnn.ops.boxes import box_overlap_gt as jax_overlap_gt
from trcnn.ops.boxes import clip_boxes as jax_clip
from trcnn.ops.nms import multiclass_nms as jax_multiclass_nms
from trcnn.ops.nms import nms_oracle_numpy, nms_padded as jax_nms
from trcnn.ops.proposal import proposal_layer as jax_proposal_layer
from trcnn.ops.roi_pool import roi_bin_bounds as jax_roi_bin_bounds
from trcnn.ops.roi_pool import roi_max_pool as jax_roi_max_pool
from trcnn.ops.roi_pool import roi_max_pool_oracle_numpy
from trcnn.ops.stem_pallas import stem_block1_reference
from trcnn.ops.topk import masked_topk_payload as jax_topk
from trcnn_torch.models import make_model
from trcnn_torch.ops import anchors, boxes, nms, proposal, roi_pool, stem, topk
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy


def _boxes(rng, n, w=200.0, h=150.0):
    x1 = rng.uniform(0, w - 20, n)
    y1 = rng.uniform(0, h - 20, n)
    bw = rng.uniform(2, w / 2, n)
    bh = rng.uniform(2, h / 2, n)
    return np.stack([x1, y1, np.minimum(x1 + bw, w - 1),
                     np.minimum(y1 + bh, h - 1)], 1).astype(np.float32)


def _near_threshold_pairs(t, count=8):
    """Equal 100-px squares shifted by d around IoU = t, stepped by ulps."""
    d0 = np.float32(100.0 * (1 - t) / (1 + t))
    out = []
    for k in range(count):
        d = d0
        for _ in range(k // 2):
            d = np.nextafter(d, np.float32(np.inf) if k % 2 else np.float32(-np.inf))
        x = np.float32(150.0 * k)
        out += [(x, 0.0, x + 99.0, 99.0), (x + d, 0.0, x + d + 99.0, 99.0)]
    return np.asarray(out, np.float32)


# ------------------------------------------------------------ anchors, boxes


@pytest.mark.parametrize("cfg", [AnchorConfig(), AnchorConfig(scales=(1.0, 2.0, 3.0))])
def test_anchors_bit_equal(cfg):
    np.testing.assert_array_equal(
        anchors.generate_base_anchors(cfg.base_size, cfg.ratios, cfg.scales),
        jax_base_anchors(cfg.base_size, cfg.ratios, cfg.scales))
    assert anchors.generate_base_anchors()[0].tolist() == [-84, -40, 99, 55]
    np.testing.assert_array_equal(anchors.shifted_anchors(5, 7, cfg).numpy(),
                                  np.asarray(jax_shifted_anchors(5, 7, cfg)))


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    b = _boxes(rng, 64)
    d = rng.normal(0, 0.5, (64, 4 * 3)).astype(np.float32)
    d[:4, 2] = 9.0            # beyond DELTA_CLIP
    want = np.asarray(jax_decode(jnp.asarray(b), jnp.asarray(d)))
    got = boxes.bbox_transform_inv(T(b), T(d)).numpy()
    # exp may differ by an ulp between the frameworks
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_clip_bit_equal():
    rng = np.random.default_rng(1)
    b = (rng.uniform(-50, 250, (32, 8))).astype(np.float32)
    want = np.asarray(jax_clip(jnp.asarray(b), jnp.float32(120.0), jnp.float32(180.0)))
    got = boxes.clip_boxes(T(b), torch.tensor(120.0), torch.tensor(180.0)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", [0.7, 0.3])
def test_overlap_predicate_bit_equal_near_threshold(t):
    pairs = _near_threshold_pairs(t)
    want = np.asarray(jax_overlap_gt(jnp.asarray(pairs), jnp.asarray(pairs), t))
    got = boxes.box_overlap_gt(T(pairs), T(pairs), t).numpy()
    np.testing.assert_array_equal(got, want)
    # the engineered steps straddle the threshold
    assert 0 < want[0::2, 1::2].diagonal().sum() < len(pairs) // 2


def test_topk_ties_to_lower_index():
    rng = np.random.default_rng(2)
    s = np.round(rng.uniform(0, 1, 200), 1).astype(np.float32)
    v = rng.uniform(0, 1, 200) > 0.2
    p = np.arange(200, dtype=np.float32)
    jv, (jp,), jok = jax_topk(jnp.asarray(s), jnp.asarray(v), 180, jnp.asarray(p))
    tv, (tp,), tok = topk.masked_topk_payload(T(s), T(v), 180, T(p))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not tok.numpy().all()


# ------------------------------------------------------------------- NMS


def _nms_case(seed, n=300, t=0.7):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 400, (12, 2))
    c = centres[rng.integers(0, 12, n)] + rng.normal(0, 6, (n, 2))
    size = rng.uniform(10, 80, (n, 2))
    b = np.concatenate([c - size / 2, c + size / 2], 1).astype(np.float32)
    pairs = _near_threshold_pairs(t)
    b[:len(pairs)] = pairs + np.float32(1000.0)
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)   # ties
    valid = rng.uniform(0, 1, n) > 0.1
    return b, scores, valid


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("t,max_out", [(0.7, 40), (0.3, 500)])
def test_nms_matches_jax(presorted, t, max_out):
    b, s, v = _nms_case(3, t=t)
    if presorted:
        order = np.argsort(-np.where(v, s, -np.inf), kind="stable")
        b, s, v = b[order], s[order], v[order]
    ji, jv = jax_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), t, max_out,
                     presorted=presorted)
    ti, tv = nms.nms_padded(T(b), T(s), T(v), t, max_out, presorted=presorted)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tv.dtype == torch.bool and ti.dtype == torch.int32


def test_nms_grouped_matches_jax():
    b, s, v = _nms_case(4, n=400, t=0.3)
    g = np.random.default_rng(5).integers(0, 5, 400).astype(np.int32)
    ji, jv = jax_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), 0.3, 120,
                     groups=jnp.asarray(g))
    ti, tv = nms.nms_padded(T(b), T(s), T(v), 0.3, 120, groups=T(g))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("seed", [6, 7])
def test_nms_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    b = _boxes(rng, 200)
    s = rng.uniform(0, 1, 200).astype(np.float32)
    keep = nms_oracle_numpy(b, s, 0.5)
    ti, tv = nms.nms_padded(T(b), T(s), torch.ones(200, dtype=torch.bool), 0.5, 200)
    assert ti[tv].tolist() == keep


def test_multiclass_nms_matches_jax():
    """The single-call path (max_per_class >= max_total) and the per-class
    path (10 per class, 50 in all) both equal JAX's."""
    rng = np.random.default_rng(8)
    r, c = 40, 6
    bx = np.repeat(_boxes(rng, r)[:, None, :], c, 1) + rng.normal(0, 2, (r, c, 4))
    bx = bx.astype(np.float32)
    sc = rng.dirichlet(np.ones(c), r).astype(np.float32)
    rv = rng.uniform(0, 1, r) > 0.1
    for per_class in (50, 10):
        want = jax_multiclass_nms(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(rv),
                                  0.3, 0.05, max_per_class=per_class, max_total=50)
        got = nms.multiclass_nms(T(bx), T(sc), T(rv), 0.3, 0.05, per_class, 50)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------- RoI pool


def _roi_case(seed, b=2, r=24, h=33, w=64, c=8):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    x1 = rng.uniform(-40, w * 16, (b, r))
    y1 = rng.uniform(-40, h * 16, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(0, 300, (b, r)),
                     y1 + rng.uniform(0, 300, (b, r))], -1)
    rois[:, 0] = (w * 16 + 100, 10, w * 16 + 200, 90)   # beyond the map: empty
    rois[:, 1] = (-100, -60, 200, 150)                  # clipped on two sides
    rois[:, 2] = (40, 40, 40, 40)                       # one cell
    rois[:, 3] = (0, 0, 16 * 56, 16 * 28)               # 57 x 29 cells
    rois[:, 4] = (24, 40, 24 + 16 * 6, 40 + 16 * 28)    # half-pixel rounding
    return feat, rois.astype(np.float32)


def test_roi_bin_bounds_ieee_quotient():
    """roi_h = 29 and roi_w = 57 at P = 7.  For 57 the float32 quotient
    decides: fl(57/7) * 7 = 57.000004, so the last bin ends at 58, not 57."""
    rois = np.asarray([[0, 0, 16 * 56, 16 * 28]], np.float32)
    want = jax_roi_bin_bounds(jnp.asarray(rois), 1 / 16, 7, 64, 64)
    got = roi_pool.roi_bin_bounds(T(rois), 1 / 16, 7, 64, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][0, -1]) == 29 and int(got[3][0, -1]) == 58


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_roi_pool_bit_equal_to_jax(dtype):
    feat, rois = _roi_case(9)
    jfeat = jnp.asarray(feat).astype(dtype)
    want = jax.vmap(lambda f, r: jax_roi_max_pool(f, r, 7, 1 / 16))(jfeat, jnp.asarray(rois))
    tfeat = T(feat).to(torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    got = roi_pool.roi_max_pool(tfeat, T(rois), 7, 1 / 16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    assert (got == 0).all(-1).any()                     # empty bins present


def test_roi_pool_matches_oracle_beyond_map_size():
    """A RoI larger than the map: the window sized from the bounds pools the
    whole bin, as the numpy oracle does."""
    feat, rois = _roi_case(10, b=1)
    rois[0, 5] = (-300, -300, 1200, 900)
    got = roi_pool.roi_max_pool(T(feat), T(rois))
    np.testing.assert_array_equal(got[0].numpy(), roi_max_pool_oracle_numpy(feat[0], rois[0]))


# ------------------------------------------------------------------- stem


def _stem_args(rng, h, w, b=2):
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 3, 64)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _oihw(w):
    return T(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("h,w", [(16, 12), (24, 64), (10, 34)])
def test_stem_matches_reference(h, w):
    x, w1, b1, w2, b2 = _stem_args(np.random.default_rng(11), h, w)
    want = np.asarray(stem_block1_reference(*map(jnp.asarray, (x, w1, b1, w2, b2))))
    got = stem.stem_block1(T(x), _oihw(w1), T(b1), _oihw(w2), T(b2)).numpy()
    assert got.shape == (2, h // 2, w // 2, 64)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_stem_rejects_odd_canvas_on_the_kernel_path():
    x, w1, b1, w2, b2 = _stem_args(np.random.default_rng(12), 8, 8)
    args = (T(x[:, :7]), _oihw(w1), T(b1), _oihw(w2), T(b2))
    with pytest.raises(ValueError):
        stem.stem_block1_cuda(*args)


# ------------------------------------------------------ proposals, prepare


def test_proposal_layer_matches_jax():
    rng = np.random.default_rng(13)
    fh, fw, a = 6, 8, 9
    fg = np.round(rng.uniform(0, 1, (fh, fw, a)), 3).astype(np.float32)
    d = rng.normal(0, 0.3, (fh, fw, a, 4)).astype(np.float32)
    acfg = AnchorConfig(scales=(1.0, 2.0, 3.0))
    pcfg = ProposalConfig(pre_nms_topk_test=192, post_nms_topk_test=24)
    info = (80.0, 110.0, 1.2)                         # grid guard cuts rows/cols
    want = jax_proposal_layer(jnp.asarray(fg), jnp.asarray(d), *info, train=False,
                              anchor_cfg=acfg, cfg=pcfg)
    got = proposal.proposal_layer(T(fg), T(d), *(torch.tensor(v) for v in info),
                                  train=False, anchor_cfg=acfg, cfg=pcfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_prepare_uint8_matches_jax():
    cfg = FasterRCNNConfig()
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    info = np.asarray([[30, 40, 1.0], [32, 20, 1.0]], np.float32)
    want = jax_make_model(cfg).apply({}, jnp.asarray(img), jnp.asarray(info),
                                     method="_prepare")
    got = make_model(cfg.replace(head_hidden=8, rpn_channels=8), device="cpu")._prepare(T(img), T(info))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
