"""The port's COCO configuration against the JAX package on the CPU.

- ``COCODetection`` equal to ``trcnn.data.coco``'s on the fixture of
  tests/test_coco.py: boxes, labels, crowd flags, class names, images;
- ``coco_eval`` equal to JAX's within 1e-12 (the same float64 numpy
  arithmetic; the tolerance only allows another summation order) on the
  fixtures of tests/test_coco.py and a seeded 81-class case;
- the 81-class epilogue bit-equal to JAX's ``postprocess`` (keep-sets,
  classes, order; scores equal, boxes within the decode's ulps) on the
  small-canvas config of tests/test_cross_impl_coco.py, both its per-class
  path (16 per class, 48 in all) and the single grouped call, with the port's
  own detect on the bridged weights within tests/test_torch_slice.py's
  tolerances; the class-group layout flip of that file must turn the check
  red;
- ``nms_padded``, which suppresses only the batch's longest valid prefix
  after its sort, equal to the untrimmed suppression and to JAX's
  ``nms_padded`` / ``batched_nms``: all valid, all invalid, one image
  without a valid pair, a short prefix, scores in tenths (ties);
- the multi-scale draw of the COCO preset: the port's loader equal to
  JAX's batch for batch, and the scale re-derived as
  tests/test_cross_impl_coco.py does;
- the evaluate and train CLIs with ``--dataset coco`` on the CPU (two
  images, one step, fc6/fc7 width 32) on an instances json with COCO's 80
  non-contiguous category ids and a crowd box.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_cross_impl_coco as xcoco
from tests.test_coco import BOX, _ann, _write_coco_fixture
from tests.test_convert import _fake_chainer_tree
from trcnn import data as jax_data
from trcnn.config import coco_config as jax_coco_config
from trcnn.data.coco import COCODetection as JaxCOCODetection
from trcnn.eval.coco_ap import coco_eval as jax_coco_eval
from trcnn.models.faster_rcnn import postprocess as jax_postprocess
from trcnn.ops.nms import batched_nms as jax_batched_nms
from trcnn.ops.nms import nms_padded as jax_nms_padded
from trcnn_torch import cli
from trcnn_torch.cli import evaluate, train
from trcnn_torch.config import coco_config
from trcnn_torch.convert import flax_to_state_dict
from trcnn_torch.data import COCODetection, DetectionLoader, SyntheticDetection
from trcnn_torch.data.preprocess import canvas_shape, preprocess_image
from trcnn_torch.eval import coco_eval
from trcnn_torch.models import make_model, postprocess
from trcnn_torch.models.faster_rcnn import RawDetections
from trcnn_torch.ops import nms
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

pytest.importorskip("cv2")

T = torch.from_numpy
AP_TOL = 1e-12


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("use_crowd", [False, True])
def test_coco_dataset_matches_the_jax_package(tmp_path, use_crowd):
    img_dir, ann_path = _write_coco_fixture(tmp_path)
    ours, theirs = COCODetection(img_dir, ann_path, use_crowd), JaxCOCODetection(
        img_dir, ann_path, use_crowd)
    assert ours.class_names == theirs.class_names == ("__background__", "person", "dog",
                                                      "bottle")
    assert len(ours) == len(theirs) == 2 and ours.cat_ids == theirs.cat_ids
    for i in range(2):
        a, b = ours.get_example(i), theirs.get_example(i)
        assert a.keys() == b.keys() and a["id"] == b["id"]
        for k in ("image", "boxes", "labels", "difficult"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert ours.get_size(i) == theirs.get_size(i) == a["image"].shape[:2]
    assert list(ours.get_annotation(0)["difficult"]) == ([False, True] if use_crowd else [False])


# ------------------------------------------------------------------ COCO AP


def _random_coco_case(seed, n_img=5, num_classes=81):
    """Ground truth of every area range with crowd regions, and detections
    that jitter it (some classes absent, some images empty, tied scores)."""
    rng = np.random.default_rng(seed)
    dets, anns = [], {}
    for i in range(n_img):
        g = int(rng.integers(0, 30))
        xy = rng.uniform(0, 500, (g, 2))
        wh = np.exp(rng.uniform(np.log(4), np.log(300), (g, 2)))
        boxes = np.concatenate([xy, xy + wh], 1)
        labels = rng.integers(1, num_classes, g)
        crowd = rng.uniform(0, 1, g) < 0.1
        anns[str(i)] = {"boxes": boxes, "labels": labels, "crowd": crowd}
        d = int(rng.integers(0, 40))
        src = rng.integers(0, max(g, 1), d)
        dboxes = (boxes[src] if g else rng.uniform(0, 500, (d, 4))) + rng.normal(0, 6, (d, 4))
        dlabels = labels[src] if g else rng.integers(1, num_classes, d)
        dlabels = np.where(rng.uniform(0, 1, d) < 0.15, rng.integers(1, num_classes, d), dlabels)
        dets.append({"id": str(i), "boxes": dboxes, "scores": np.round(rng.uniform(0, 1, d), 1),
                     "classes": dlabels})
    return dets, anns


SHIFTED = [10.0, 10.0 + 50 * 0.25, 60.0, 60.0 + 50 * 0.25]
FAR = [200.0, 200.0, 260.0, 250.0]
AP_CASES = {
    # tests/test_coco.py's three fixtures, then the seeded 81-class case
    "perfect": ([{"id": "a", "boxes": np.asarray([BOX]), "scores": np.asarray([0.9]),
                  "classes": np.asarray([1])}], {"a": _ann([BOX], [1])}, 3),
    "iou_sensitivity": ([{"id": "a", "boxes": np.asarray([SHIFTED]), "scores": np.asarray([0.9]),
                          "classes": np.asarray([1])}], {"a": _ann([BOX], [1])}, 2),
    "crowd": ([{"id": "a", "boxes": np.asarray([BOX, FAR]), "scores": np.asarray([0.9, 0.8]),
                "classes": np.asarray([1, 1])}],
              {"a": _ann([BOX, FAR], [1, 1], crowd=[False, True])}, 2),
    "random_81": _random_coco_case(3) + (81,),
}


@pytest.mark.parametrize("case", list(AP_CASES))
def test_coco_eval_matches_the_jax_package(case):
    dets, anns, k = AP_CASES[case]
    for area in ("all", "small", "medium", "large"):
        for max_dets in (100, 3):
            got = coco_eval(dets, anns, k, area_range=area, max_dets=max_dets)
            want = jax_coco_eval(dets, anns, k, area_range=area, max_dets=max_dets)
            assert got.keys() == want.keys() == {"AP", "AP50", "AP75"}
            for key in got:
                assert abs(got[key] - want[key]) <= AP_TOL, (area, max_dets, key)
    if case == "random_81":
        assert 0.0 < coco_eval(dets, anns, k)["AP"] < 1.0


# ------------------------------------------------- the 81-class epilogue


@pytest.fixture(scope="module")
def coco_raw():
    """tests/test_cross_impl_coco.py's small 81-class config: its JAX raw
    head outputs, and the port's detect on the bridged weights."""
    cfg, model, params, images, im_info = xcoco._fixture()
    raw = jax.tree.map(np.asarray, xcoco._graph_raw(cfg, model, params, images, im_info))
    port = make_model(cfg, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        ours = port.eval().detect(T(images.copy()), T(im_info.copy()))
    return cfg, raw, [t.numpy() for t in ours], im_info


def _epilogues(cfg, raw, im_info, bbox_pred=None):
    """The port's and JAX's postprocess on the same raw outputs (the port's
    with ``bbox_pred`` in place of raw's, when given)."""
    want = jax_postprocess(raw, jnp.asarray(im_info), cfg)
    ours = RawDetections(*(T(np.array(a)) for a in (
        raw.rois, raw.roi_valid, raw.cls_prob, raw.bbox_pred if bbox_pred is None else bbox_pred)))
    got = postprocess(ours, T(np.array(im_info)), cfg)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


def _same_detections(got, want) -> bool:
    """Equal keep-sets, classes and order (validity, classes and scores
    slot for slot), boxes within the decode's ulps."""
    return (np.array_equal(got[3], want[3]) and np.array_equal(got[2], want[2])
            and np.array_equal(got[1], want[1])
            and np.allclose(got[0], want[0], rtol=1e-5, atol=1e-3))


def test_coco_detect_matches_jax(coco_raw):
    """The port's 81-class detect (324-wide bbox head) on the bridged
    weights against the JAX graph's raw outputs.  The proposals' corners
    within 1e-5 relative + 1e-3 px: the calibrated RPN deltas (0.15 sigma)
    carry the float32 trunk's last-bit differences (XLA's and PyTorch's
    convolutions sum in other orders) through the decode's exp."""
    _, raw, (rois, roi_valid, cls_prob, bbox_pred), _ = coco_raw
    assert cls_prob.shape[-1] == 81 and bbox_pred.shape[-1] == 4 * 81
    np.testing.assert_array_equal(roi_valid, raw.roi_valid)
    np.testing.assert_allclose(rois, raw.rois, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(cls_prob, raw.cls_prob, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bbox_pred, raw.bbox_pred, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("per_class,total", [(2, 48), (16, 20), (48, 48)])
def test_coco_epilogue_bit_equal_to_jax(coco_raw, per_class, total):
    """max_per_class < max_total takes multiclass_nms's per-class path (one
    K1 batch of B x 80 rows), here with the per-class cap binding (2 of a
    class's 5 survivors) and with the total binding (20 of 30); 48 of 48
    the single grouped call."""
    cfg, raw, _, im_info = coco_raw
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, max_dets_per_class=per_class,
                                               max_dets_per_image=total))
    got, want = _epilogues(cfg, raw, im_info)
    assert _same_detections(got, want)
    classes = got[2][got[3]]
    assert len(set(classes.tolist())) >= 8                 # many of the 80 classes
    assert np.bincount(classes).max() <= per_class and len(classes) <= total
    assert np.bincount(classes).max() == per_class or len(classes) == total or per_class == 48


def test_coco_epilogue_check_catches_the_layout_flip(coco_raw):
    """tests/test_cross_impl_coco.py's mutation: bbox_pred read class-minor
    (R, 4, 81) instead of class-grouped (R, 81, 4) must break the check."""
    cfg, raw, _, im_info = coco_raw
    bp = raw.bbox_pred
    r = bp.shape[1]
    flipped = bp.reshape(1, r, 4, 81).transpose(0, 1, 3, 2).reshape(1, r, 4 * 81)
    got, want = _epilogues(cfg, raw, im_info, flipped)
    assert not _same_detections(got, want)


# ------------------------------------------------- the valid-prefix trim


def _nms_batch(seed, b, n, frac_valid, n_groups=0):
    """Clustered boxes with scores in tenths (ties, also between valid and
    invalid entries), ``frac_valid[i]`` of image i valid."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 300, (b, n, 2))
    s = rng.uniform(8, 80, (b, n, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (b, n)), 1).astype(np.float32)
    valid = rng.uniform(0, 1, (b, n)) < np.asarray(frac_valid)[:, None]
    groups = rng.integers(0, n_groups, (b, n)).astype(np.int32) if n_groups else None
    return boxes, scores, valid, groups


TRIM_CASES = {
    "all_valid": (1, 2, 300, (1.0, 1.0)),
    "all_invalid": (2, 2, 300, (0.0, 0.0)),
    "one_image_without_a_valid_pair": (3, 3, 700, (0.3, 0.0, 0.08)),
    "short_prefix": (4, 2, 1000, (0.04, 0.02)),
}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("case", list(TRIM_CASES))
def test_trimmed_nms_equals_untrimmed_and_jax(case, grouped, monkeypatch):
    seed, b, n, frac = TRIM_CASES[case]
    boxes, scores, valid, groups = _nms_batch(seed, b, n, frac, 6 if grouped else 0)
    t, max_out = 0.3, 40
    args = (T(boxes), T(scores), T(valid), t, max_out)
    g = None if groups is None else T(groups)
    widths = []
    real = nms.valid_prefix

    def recorded(svalid):
        widths.append(real(svalid))
        return widths[-1]

    monkeypatch.setattr(nms, "valid_prefix", recorded)
    got = nms.nms_padded(*args, groups=g)
    monkeypatch.setattr(nms, "valid_prefix", lambda sv: sv.shape[-1])
    untrimmed = nms.nms_padded(*args, groups=g)
    monkeypatch.setattr(nms, "valid_prefix", real)
    longest = int(valid.sum(-1).max())
    assert widths == [min(n, max(64, -(-longest // 64) * 64))]
    if case == "short_prefix":
        assert widths[0] < n // 4
    for x, y in zip(got, untrimmed):
        assert torch.equal(x, y)
    if grouped:
        want = [jax_nms_padded(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                               jnp.asarray(valid[i]), t, max_out, groups=jnp.asarray(groups[i]))
                for i in range(b)]
        want = [np.stack([np.asarray(w[k]) for w in want]) for k in range(2)]
    else:
        want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), t,
                               max_out)
        assert all(torch.equal(x, y) for x, y in zip(nms.batched_nms(*args), got))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    kept = got[1].sum(-1).tolist()
    if case == "all_invalid":
        assert kept == [0, 0]
    elif case == "one_image_without_a_valid_pair":
        assert kept[1] == 0 and kept[0] == max_out and 0 < kept[2]


# ------------------------------------------------- the CLIs


HIDDEN = 32
N_CATS = 80


def write_coco_tree(root, images, boxes):
    """``images`` written as <root>/images/<id>.png and an instances json
    with COCO's 80 category ids (sparse in 1..90); ``boxes[i]`` are
    (x, y, w, h, category_index, iscrowd) rows of image i.  Returns (image
    dir, json path)."""
    import cv2

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    ids = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
    assert len(ids) == N_CATS
    cats = [{"id": cid, "name": f"class_{cid}"} for cid in ids]
    imgs, anns = [], []
    for i, (img, rows) in enumerate(zip(images, boxes)):
        name = f"{i:012d}.png"
        assert cv2.imwrite(os.path.join(img_dir, name), img)
        imgs.append({"id": 1000 + i, "file_name": name, "height": img.shape[0],
                     "width": img.shape[1]})
        for x, y, w, h, c, crowd in rows:
            anns.append({"id": len(anns) + 1, "image_id": 1000 + i, "category_id": ids[c],
                         "bbox": [x, y, w, h], "iscrowd": crowd, "area": w * h})
    ann_file = os.path.join(root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump({"images": imgs, "annotations": anns, "categories": cats}, f)
    return img_dir, ann_file


@pytest.fixture(scope="module")
def coco_files(tmp_path_factory):
    """Two landscape images (one detect call at batch 2) with a crowd box,
    and an 81-class VGG-16 npz (fc6/fc7 width 32) rescaled as
    tests/test_torch_cli.py does, its class biases graded so that few
    classes clear the score threshold."""
    d = tmp_path_factory.mktemp("coco_cli")
    rng = np.random.RandomState(0)
    tree = _fake_chainer_tree(rng, num_classes=81, hidden=HIDDEN)
    for k, v in list(tree.items()):
        if k.endswith("/W") and v.ndim == 4:
            tree[k] = (v / v.std() * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
    tree["rpn/rpn_bbox_pred/W"] *= 0.1
    tree["bbox_pred/W"] *= 0.1
    tree["cls_score/b"] = np.linspace(-3.0, 3.0, 81).astype(np.float32)
    npz = str(d / "VGG16_coco.npz")
    np.savez(npz, **tree)
    images = [rng.randint(0, 256, (120, 160, 3), np.uint8),
              rng.randint(0, 256, (90, 140, 3), np.uint8)]
    boxes = [[(10.0, 20.0, 50.0, 40.0, 79, 0), (60.0, 10.0, 30.0, 30.0, 0, 1),
              (80.0, 50.0, 60.0, 50.0, 76, 0)],
             [(5.0, 5.0, 60.0, 40.0, 78, 0)]]
    img_dir, ann_file = write_coco_tree(str(d), images, boxes)
    return d, npz, img_dir, ann_file


def _cfg(backbone="vgg16", preset="voc"):
    return cli.make_config(backbone, preset).replace(head_hidden=HIDDEN)


@pytest.fixture(autouse=True)
def narrow_head(monkeypatch):
    for mod in (evaluate, train):
        monkeypatch.setattr(mod, "make_config", _cfg)


def test_evaluate_cli_reports_coco_ap(coco_files, capsys):
    d, npz, img_dir, ann_file = coco_files
    res = evaluate.run(["--dataset", "coco", "--dataset_root", img_dir, "--ann_file", ann_file,
                        "--pretrained_model", npz, "--batch_size", "2", "--device", "cpu"])
    assert res["images"] == 2 and res["timing"]["batches"] == {(800, 1344): 1}
    out = res["metrics"]
    assert res["mAP"] is None and set(out) >= {"eval_AP", "eval_AP50", "eval_AP75"}
    assert sum(len(x["scores"]) for x in res["detections"]) > 0
    ds = COCODetection(img_dir, ann_file, use_crowd=True)
    assert len(ds.class_names) == 81
    anns = {a["id"]: dict(a, crowd=a["difficult"])
            for a in (ds.get_annotation(i) for i in range(2))}
    assert anns["1000"]["difficult"].tolist() == [False, True, False]
    for impl in (coco_eval, jax_coco_eval):
        want = impl(res["detections"], anns, 81)
        assert (out["eval_AP"], out["eval_AP50"], out["eval_AP75"]) == (
            want["AP"], want["AP50"], want["AP75"])
    text = capsys.readouterr().out
    assert f"AP={out['eval_AP']:.4f} AP50={out['eval_AP50']:.4f}" in text
    for argv in (["--dataset", "coco", "--dataset_root", img_dir],
                 ["--dataset", "coco", "--ann_file", ann_file]):
        with pytest.raises(SystemExit):
            evaluate.parse(argv)


def test_train_cli_takes_a_coco_step(coco_files, capsys):
    d, npz, img_dir, ann_file = coco_files
    out = str(d / "train")
    trainer = train.run(["--dataset", "coco", "--coco_image_root", img_dir,
                         "--coco_ann_file", ann_file, "--pretrained_model", npz,
                         "--batch_size", "1", "--iters", "1", "--log_every", "1", "--out", out,
                         "--no_writer", "--device", "cpu"])
    assert trainer.state.step == 1 and os.listdir(out) == ["ckpt_00000001.pt"]
    assert trainer.cfg.num_classes == 81 and trainer.cfg.image.pad_w == 1344
    assert trainer.state.model.head.cls_score.weight.shape[0] == 81
    assert '"step": 1' in capsys.readouterr().out
    base = ["--dataset", "coco", "--coco_image_root", img_dir]
    for argv in (base, base + ["--coco_ann_file", ann_file, "--eval_every", "1"]):
        with pytest.raises(SystemExit):
            train.parse(argv)
    assert train.parse(["--dataset", "synthetic", "--config", "coco"]).config == "coco"


# ------------------------------------------------- the valid-prefix trim, presorted


def test_presorted_nms_is_not_trimmed(monkeypatch):
    """The proposal layer's presorted input is suppressed whole: no read
    back to the host."""
    boxes, scores, valid, _ = _nms_batch(5, 2, 200, (0.5, 0.5))
    order = np.argsort(-np.where(valid, scores, -np.inf), axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, order, 1)  # noqa: E731
    sboxes = np.take_along_axis(boxes, order[..., None], 1)

    def refuse(_):
        raise AssertionError("presorted input was trimmed")

    monkeypatch.setattr(nms, "valid_prefix", refuse)
    got = nms.nms_padded(T(sboxes), T(take(scores)), T(take(valid)), 0.7, 50, presorted=True)
    want = jax_batched_nms(jnp.asarray(sboxes), jnp.asarray(take(scores)),
                           jnp.asarray(take(valid)), 0.7, 50)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# ------------------------------------------------- the multi-scale draw


def test_coco_multiscale_draw_matches_the_jax_package():
    """The COCO preset's multi-scale training draw: the port's loader gives
    JAX's shorter sides, scales, canvases and boxes batch for batch (the
    images themselves: tests/test_torch_data.py), and each shorter side of
    the list gives the scale re-derived as tests/test_cross_impl_coco.py
    does, in one canvas bucket per orientation."""
    ours_cfg, theirs_cfg = coco_config().image, jax_coco_config().image
    kw = dict(batch_size=2, augment=True, shuffle=True, seed=9, uint8_images=True)
    hw = ((300, 480), (400, 1200))
    ours = DetectionLoader(SyntheticDetection(n=6, hw_range=hw, seed=2), image_cfg=ours_cfg, **kw)
    theirs = jax_data.DetectionLoader(jax_data.SyntheticDetection(n=6, hw_range=hw, seed=2),
                                      image_cfg=theirs_cfg, **kw)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 3
    scales = set()
    for g, w in zip(got, want):
        assert g.ids == w.ids and g.images.shape == w.images.shape
        for k in ("im_info", "gt_boxes", "gt_labels", "gt_valid"):
            assert np.array_equal(getattr(g, k), getattr(w, k)), k
        scales |= {float(v) for v in g.im_info[:, 2]}
    assert len(scales) >= 3

    rng = np.random.RandomState(0)
    for h, w in ((480, 640), (300, 1200), (640, 480)):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        for ms in ours_cfg.multiscale_min_sizes:
            canvas, info = preprocess_image(img, ours_cfg, min_size=ms, as_uint8=True)
            want_scale = float(ms) / min(h, w)
            if round(want_scale * max(h, w)) > ours_cfg.target_max_size:
                want_scale = float(ours_cfg.target_max_size) / max(h, w)
            assert abs(float(info[2]) - want_scale) < 1e-6
            assert (int(info[0]), int(info[1])) == (round(h * want_scale), round(w * want_scale))
            assert canvas.shape[:2] == canvas_shape(h, w, ours_cfg) == (
                (800, 1344) if w >= h else (1344, 800))
