"""The port against the independent numpy pipeline, stage by stage, float32.

tests/test_cross_impl.py holds the JAX graph to tests/cross_impl_reference.py
(a pure-numpy Faster R-CNN forward) on its calibrated weights
(``_fixture``: the RPN and head output kernels rescaled so that scores
spread).  This file holds the port to the same reference on the same
weights and image (the run's shared copy of that fixture), at the same
limits: the trunk within 1e-4 of the largest feature (``_rel_err``), the
RPN within 1e-5, the head within 1e-4; the proposal layer and the epilogue
re-fed the port's own inputs and required to make the same decisions
(validity and classes equal, boxes within the decode's 2e-3); the whole
chain from the image within the float32 drift of 13 convolutions (scores
1e-3, boxes 0.1 px).
"""

import numpy as np
import pytest
import torch

from tests import cross_impl_reference as ref
from tests.test_cross_impl import _rel_err
from tests.torch_shared import vgg_detect_fixture
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.models import make_model, postprocess
from trcnn_torch.models.faster_rcnn import RawDetections
from trcnn_torch.ops.proposal import proposal_layer
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

T = torch.from_numpy


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's detect and epilogue on the fixture, with its features and
    RPN outputs."""
    cfg, _, params, images, im_info = vgg_detect_fixture(tmp_path_factory)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    model.eval()
    x, info = T(np.array(images)), T(np.array(im_info))
    with torch.no_grad():
        feat = model.extractor(model._prepare(x, info))
        rpn = model.rpn(feat)
        raw = model.detect(x, info)
        dets = postprocess(raw, info, cfg)
    return dict(cfg=cfg, params=params, images=np.asarray(images), im_info=np.asarray(im_info),
                feat=feat.numpy(), rpn=rpn, raw=[t.numpy() for t in raw],
                dets=[t.numpy() for t in dets])


def test_backbone_and_rpn_numerics(port):
    p, cfg = port["params"]["params"], port["cfg"]
    feat_n = ref.vgg16_features(p["extractor"], port["images"][0])
    assert _rel_err(port["feat"][0], feat_n) < 1e-4
    # the same feature input on both sides: elementwise conv and softmax
    fg_n, deltas_n = ref.rpn_forward(p["rpn"], port["feat"][0], cfg.anchors.num_anchors)
    assert _rel_err(port["rpn"].fg_probs.numpy()[0], fg_n) < 1e-5
    assert _rel_err(port["rpn"].deltas.numpy()[0], deltas_n) < 1e-5


def test_proposal_stage_discrete_exact(port):
    """The port's RPN tensors into both proposal layers: identical keep
    decisions, corners within the decode's exp (2e-3)."""
    cfg = port["cfg"]
    fg = port["rpn"].fg_probs.numpy()[0]
    dl = port["rpn"].deltas.numpy()[0]
    ih, iw, sc = (float(v) for v in port["im_info"][0])
    props = proposal_layer(T(fg), T(dl), ih, iw, sc, train=False, anchor_cfg=cfg.anchors,
                           cfg=cfg.proposals)
    rois_n, valid_n = ref.proposal_forward(
        fg, dl, ih, iw, sc,
        stride=cfg.anchors.feat_stride,
        base=ref.base_anchors(cfg.anchors.base_size, cfg.anchors.ratios, cfg.anchors.scales),
        pre_k=cfg.proposals.pre_nms_topk_test, post_k=cfg.proposals.post_nms_topk_test,
        nms_thresh=cfg.proposals.nms_thresh, min_size=cfg.proposals.min_size)
    np.testing.assert_array_equal(props.valid.numpy(), valid_n)
    assert valid_n.sum() > 0
    np.testing.assert_allclose(props.rois.numpy(), rois_n, atol=2e-3)


def test_roi_head_numerics(port):
    """The reference's RoI max pool and head on the port's features and
    proposals: cls_prob and bbox_pred within 1e-4."""
    cfg, (rois, _, cls_prob, bbox_pred) = port["cfg"], port["raw"]
    pooled_n = ref.roi_max_pool_oracle_numpy(port["feat"][0], rois[0],
                                             out_size=cfg.roi.output_size,
                                             spatial_scale=cfg.roi.spatial_scale)
    cls_n, bp_n = ref.roi_head_forward(port["params"]["params"]["head"], pooled_n)
    assert _rel_err(cls_prob[0], ref.softmax(cls_n, axis=-1)) < 1e-4
    assert _rel_err(bbox_pred[0], bp_n) < 1e-4


def test_postprocess_stage_discrete_exact(port):
    """The port's raw head outputs into both epilogues: the same detections
    (class-specific decode, per-class NMS, merge order)."""
    cfg, im_info = port["cfg"], port["im_info"]
    rois, roi_valid, cls_prob, bbox_pred = port["raw"]
    ih, iw, sc = (float(v) for v in im_info[0])
    b_n, s_n, c_n, v_n = ref.postprocess_forward(
        rois[0], roi_valid[0], cls_prob[0], bbox_pred[0], ih, iw, sc,
        num_classes=cfg.num_classes, stds=cfg.proposal_targets.bbox_normalize_stds,
        means=cfg.proposal_targets.bbox_normalize_means, nms_thresh=cfg.test.nms_thresh,
        score_thresh=cfg.test.score_thresh_eval, max_total=cfg.test.max_dets_per_image)
    raw = RawDetections(*(T(np.array(a)) for a in port["raw"]))
    boxes, scores, classes, valid = (t.numpy()[0] for t in postprocess(raw, T(im_info), cfg))
    np.testing.assert_array_equal(valid, v_n)
    assert v_n.sum() > 3
    np.testing.assert_array_equal(classes, c_n)
    np.testing.assert_allclose(scores, s_n, atol=1e-6)
    np.testing.assert_allclose(boxes, b_n, atol=2e-3)


def test_full_chain_end_to_end(port):
    """The independently composed numpy chain reproduces the port's
    detections from the image."""
    ih, iw, sc = (float(v) for v in port["im_info"][0])
    out = ref.full_forward(port["params"], port["images"][0], ih, iw, sc, port["cfg"])
    b_n, s_n, c_n, v_n = out["detections"]
    boxes, scores, classes, valid = (a[0] for a in port["dets"])
    assert v_n.sum() == valid.sum() > 3
    np.testing.assert_array_equal(classes, c_n)
    np.testing.assert_allclose(scores, s_n, atol=1e-3)
    np.testing.assert_allclose(boxes, b_n, atol=0.1)
