"""The port's detect slice against the JAX package, end to end on the CPU.

The config and inputs are those of tests/test_golden_e2e.py; the JAX model's
initialised parameters reach the port through trcnn_torch.convert.  The
discrete outputs (proposal validity, the selected proposals, detection
validity and classes) must be equal; float outputs agree within the stated
tolerances, and the port reproduces tests/golden_e2e.json under that test's
own tolerances.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trcnn.config import FasterRCNNConfig, ProposalConfig
from trcnn.models import make_model as jax_make_model
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn_torch.convert import flax_to_state_dict, state_dict_to_flax
from trcnn_torch.models import make_model, postprocess

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_e2e.json")


def _cfg():
    return FasterRCNNConfig(
        head_hidden=32, rpn_channels=16,
        proposals=ProposalConfig(pre_nms_topk_test=192, post_nms_topk_test=24,
                                 pre_nms_topk_train=192, post_nms_topk_train=48))


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg()
    jmodel = jax_make_model(cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    images = jax.random.uniform(k1, (1, 64, 96, 3)) * 120.0 - 60.0
    im_info = jnp.asarray([[60.0, 90.0, 1.2]], jnp.float32)
    # jitted: one compile instead of the model's ops run one by one (4x faster)
    params = jax.jit(jmodel.init)(k2, images, im_info)
    jraw = jmodel.apply(params, images, im_info, method="detect")
    jdets = jax_postprocess(jraw, im_info, cfg, score_thresh=0.02)

    model = make_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        x = torch.tensor(np.asarray(images))
        info = torch.tensor(np.asarray(im_info))
        raw = model.detect(x, info)
        dets = postprocess(raw, info, cfg, score_thresh=0.02)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (as_np(jraw), as_np(jdets),
            [t.numpy() for t in raw], [t.numpy() for t in dets],
            as_np(params), model)


def test_bridge_round_trip_is_exact(runs):
    tree, model = runs[4], runs[5]
    back = state_dict_to_flax(flax_to_state_dict(tree))
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        assert flat_back[k].dtype == v.dtype
        np.testing.assert_array_equal(flat_back[k], v)
    sd = model.state_dict()
    sd_back = flax_to_state_dict(state_dict_to_flax(sd))
    assert sd.keys() == sd_back.keys()
    for k, v in sd.items():
        assert torch.equal(sd_back[k], v)
    # layouts: conv HWIO -> OIHW, dense (in, out) -> (out, in)
    k11 = tree["params"]["extractor"]["conv1_1"]["kernel"]
    np.testing.assert_array_equal(sd["extractor.conv1_1.weight"].numpy(),
                                  k11.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.fc6.weight"].numpy(),
                                  tree["params"]["head"]["fc6"]["kernel"].T)


def test_slice_matches_jax(runs):
    jraw, jdets, raw, dets = runs[:4]
    rois, roi_valid, cls_prob, bbox_pred = raw
    boxes, scores, classes, valid = dets
    np.testing.assert_array_equal(roi_valid, jraw.roi_valid)
    assert roi_valid.sum() > 0
    # the same proposals in the same order; coordinates differ only by the
    # decode's exp (an ulp)
    np.testing.assert_allclose(rois, jraw.rois, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(cls_prob, jraw.cls_prob, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bbox_pred, jraw.bbox_pred, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(valid, jdets.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(classes, jdets.classes)
    np.testing.assert_allclose(boxes, jdets.boxes, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(scores, jdets.scores, rtol=1e-4, atol=1e-6)


def test_slice_reproduces_golden(runs):
    raw, dets = runs[2:4]
    with open(GOLDEN) as f:
        g = json.load(f)
    v = dets[3][0]
    assert int(v.sum()) == g["n_valid"]
    np.testing.assert_allclose(raw[0].sum(), g["roi_sum"], rtol=2e-4)
    np.testing.assert_allclose(raw[2].mean(), g["cls_prob_mean"], rtol=1e-5)
    np.testing.assert_allclose(dets[0][0][v][:10], np.asarray(g["boxes"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dets[1][0][v][:10], np.asarray(g["scores"]),
                               rtol=1e-4, atol=1e-6)
    assert list(dets[2][0][v][:10]) == g["classes"]
