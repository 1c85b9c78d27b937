"""The port's batched proposal layer, epilogue and NMS against the JAX
package on the CPU.

The port writes out the batch that the JAX model gets from ``jax.vmap``:
one sort and one NMS call for all images.  Inputs are made with numpy from
a seed; the images of a batch get different ``im_info`` rows, so that each
image's guards and clip are its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trcnn.config import AnchorConfig, FasterRCNNConfig, ProposalConfig
from trcnn.models.faster_rcnn import RawDetections as JaxRaw
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn.ops.nms import nms_oracle_numpy
from trcnn.ops.proposal import proposal_layer as jax_proposal_layer
from trcnn_torch.models.faster_rcnn import RawDetections, postprocess
from trcnn_torch.ops import nms, proposal
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy


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


def _sorted_batch(seed, b, n, t):
    """(B, N) score-sorted boxes: clusters, near-threshold pairs at the
    front, tied scores; image 1 has no valid box."""
    rng = np.random.default_rng(seed)
    boxes = np.empty((b, n, 4), np.float32)
    valid = np.empty((b, n), bool)
    for i in range(b):
        c = rng.uniform(0, 400, (8, 2))[rng.integers(0, 8, n)] + rng.normal(0, 6, (n, 2))
        size = rng.uniform(10, 80, (n, 2))
        bx = np.concatenate([c - size / 2, c + size / 2], 1).astype(np.float32)
        pairs = _near_threshold_pairs(t)
        bx[:len(pairs)] = pairs + np.float32(500.0 + 10 * i)
        s = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)
        s[:len(pairs)] = 2.0           # the pairs lead, in their own order
        v = rng.uniform(0, 1, n) > 0.1
        order = np.argsort(-np.where(v, s, -np.inf), kind="stable")
        boxes[i], valid[i] = bx[order], v[order]
    if b > 1:
        valid[1] = False
    return boxes, valid


@pytest.mark.parametrize("t,max_out", [(0.7, 300), (0.3, 40)])
def test_batched_greedy_keep_equals_per_image_and_oracle(t, max_out):
    boxes, valid = _sorted_batch(20, 3, 200, t)
    kp, kv = nms.greedy_keep_plain(T(boxes), T(valid), t, max_out)
    assert kp.shape == (3, max_out) and kv.shape == (3, max_out)
    assert not kv[1].any() and (kp[1] == 0).all()             # the all-invalid image
    for i in range(3):
        pp, pv = nms.greedy_keep_plain(T(boxes[i]), T(valid[i]), t, max_out)
        assert torch.equal(kp[i], pp) and torch.equal(kv[i], pv)
        # the oracle over the valid boxes in score order
        idx = np.flatnonzero(valid[i])
        ranks = -np.arange(len(idx), dtype=np.float32)
        keep = [int(idx[j]) for j in nms_oracle_numpy(boxes[i][idx], ranks, t)][:max_out]
        assert kp[i][kv[i]].tolist() == keep
    # fewer survivors than max_out at 0.7; the early exit at max_out at 0.3
    kept = int(kv[0].sum())
    assert 0 < kept < max_out if t == 0.7 else kept == max_out


def test_batched_grouped_nms_equals_per_image():
    rng = np.random.default_rng(21)
    boxes, valid = _sorted_batch(22, 2, 300, 0.3)
    scores = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    groups = rng.integers(0, 6, (2, 300)).astype(np.int32)
    bi, bv = nms.nms_padded(T(boxes), T(scores), T(valid), 0.3, 100, groups=T(groups))
    for i in range(2):
        pi, pv = nms.nms_padded(T(boxes[i]), T(scores[i]), T(valid[i]), 0.3, 100,
                                groups=T(groups[i]))
        assert torch.equal(bi[i], pi) and torch.equal(bv[i], pv)


def test_batched_proposal_layer_matches_jax_vmap():
    rng = np.random.default_rng(23)
    b, fh, fw, a = 2, 6, 8, 9
    fg = np.round(rng.uniform(0, 1, (b, fh, fw, a)), 3).astype(np.float32)
    d = rng.normal(0, 0.3, (b, fh, fw, a, 4)).astype(np.float32)
    info = np.asarray([[80.0, 110.0, 1.2], [96.0, 70.0, 1.0]], np.float32)
    acfg = AnchorConfig(scales=(1.0, 2.0, 3.0))
    pcfg = ProposalConfig(pre_nms_topk_test=192, post_nms_topk_test=24)
    want = jax.vmap(lambda p, dd, i: jax_proposal_layer(
        p, dd, i[0], i[1], i[2], train=False, anchor_cfg=acfg, cfg=pcfg))(
        jnp.asarray(fg), jnp.asarray(d), jnp.asarray(info))
    got = proposal.proposal_layer(T(fg), T(d), T(info[:, 0]), T(info[:, 1]),
                                  T(info[:, 2]), train=False, anchor_cfg=acfg, cfg=pcfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any(1).all()
    assert float(got.rois[1, :, 2].max()) <= 69.0 < float(got.rois[0, :, 2].max())
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    # each image of the batch equals its own one-image call
    for i in range(b):
        one = proposal.proposal_layer(T(fg[i]), T(d[i]), *map(float, info[i]), train=False,
                                      anchor_cfg=acfg, cfg=pcfg)
        assert torch.equal(one.valid, got.valid[i]) and torch.equal(one.rois, got.rois[i])


def test_batched_postprocess_matches_jax():
    cfg = FasterRCNNConfig()
    rng = np.random.default_rng(24)
    b, r, c = 2, 24, cfg.num_classes
    x1 = rng.uniform(0, 300, (b, r))
    y1 = rng.uniform(0, 200, (b, r))
    rois = np.stack([x1, y1, x1 + rng.uniform(20, 200, (b, r)),
                     y1 + rng.uniform(20, 150, (b, r))], -1).astype(np.float32)
    roi_valid = rng.uniform(0, 1, (b, r)) > 0.15
    cls_prob = rng.dirichlet(np.full(c, 0.3), (b, r)).astype(np.float32)
    bbox_pred = rng.normal(0, 1.0, (b, r, 4 * c)).astype(np.float32)
    info = np.asarray([[300.0, 400.0, 1.5], [240.0, 320.0, 1.0]], np.float32)
    want = jax_postprocess(JaxRaw(*map(jnp.asarray, (rois, roi_valid, cls_prob, bbox_pred))),
                           jnp.asarray(info), cfg, score_thresh=0.02)
    got = postprocess(RawDetections(*map(T, (rois, roi_valid, cls_prob, bbox_pred))),
                      T(info), cfg, score_thresh=0.02)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid[0].sum()) and 0 < int(got.valid[1].sum())
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    # the decode's exp may differ by an ulp between the frameworks
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-3)
