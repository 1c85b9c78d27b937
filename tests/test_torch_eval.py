"""The port's evaluation against the JAX package's, on the CPU, and its
evaluator and trainer hook at the tiny config.

AP: ``voc_ap``, ``voc_eval_class``, ``build_records`` and ``voc_mean_ap``
equal to the JAX package's, exactly, on tests/test_eval.py's cases (a
match, a duplicate, a localisation miss, a difficult gt) and on a seeded
random dataset of detections with ties, both metrics; the devkit files
byte-identical.  The evaluator at ``__graft_entry__._tiny_cfg`` on the CPU
gives, per image, what the port's own ``postprocess(detect(...))`` gives on
the same batches, with the padded duplicates of partial batches dropped.
The trainer's evaluator hook fires every ``eval_every`` steps and after the
last step.
"""

import copy
import filecmp
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_eval import BOX, FAR, _record
from trcnn_torch.config import VOC_CLASSES
from trcnn_torch.data import DetectionLoader, SyntheticDetection
from trcnn_torch.data.loader import upload
from trcnn_torch.eval import Evaluator, coco_eval
from trcnn_torch.models import make_model, postprocess
from trcnn_torch.train import TrainConfig, Trainer
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from __graft_entry__ import _tiny_cfg  # noqa: E402

# the modules (each package exports a function of the same name)
jax_ap = importlib.import_module("trcnn.eval.voc_ap")
voc_ap = importlib.import_module("trcnn_torch.eval.voc_ap")

RECORD_CASES = {
    "match": dict(dets=[("a", 0.9, BOX), ("b", 0.8, FAR)], gts={"a": [BOX], "b": [FAR]}),
    "duplicate": dict(dets=[("a", 0.9, BOX), ("a", 0.8, [12.0, 12.0, 62.0, 62.0])],
                      gts={"a": [BOX]}),
    "miss": dict(dets=[("a", 0.9, [100.0, 100.0, 140.0, 140.0])], gts={"a": [BOX]}),
    "difficult": dict(dets=[("a", 0.9, BOX)], gts={"a": [BOX, FAR]},
                      difficult={"a": [True, False]}),
}


def _random_outputs(seed=0, n_img=12):
    """Per-image detections (tied scores, boxes near the gt) and
    annotations with difficult objects, over 4 classes."""
    rng = np.random.RandomState(seed)
    dets, anns = [], {}
    for i in range(n_img):
        g = rng.randint(0, 5)
        gt = rng.uniform(0, 200, (g, 2))
        gt = np.concatenate([gt, gt + rng.uniform(10, 80, (g, 2))], 1)
        anns[f"im{i}"] = {"boxes": gt, "labels": rng.randint(1, 4, g),
                          "difficult": rng.rand(g) < 0.2}
        d = rng.randint(0, 8)
        src = gt[rng.randint(0, g, d)] if g else rng.uniform(0, 200, (d, 4))
        dets.append({"id": f"im{i}", "boxes": src + rng.normal(0, 6, (d, 4)),
                     "scores": np.round(rng.uniform(0, 1, d), 1),
                     "classes": rng.randint(1, 4, d)})
    return dets, anns


@pytest.mark.parametrize("metric07", [True, False], ids=["voc07", "voc"])
@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_eval_class_matches_the_jax_package(case, metric07):
    rec = _record(**RECORD_CASES[case])
    got = voc_ap.voc_eval_class(voc_ap.DetectionRecord(**vars(rec)), 0.5, metric07)
    want = jax_ap.voc_eval_class(rec, 0.5, metric07)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert voc_ap.voc_ap(want[1], want[2], metric07) == jax_ap.voc_ap(want[1], want[2], metric07)


@pytest.mark.parametrize("metric07", [True, False], ids=["voc07", "voc"])
def test_mean_ap_matches_the_jax_package(metric07):
    dets, anns = _random_outputs()
    names = ("__background__", "a", "b", "c")
    got = voc_ap.voc_mean_ap(voc_ap.build_records(names, dets, anns), use_07_metric=metric07)
    want = jax_ap.voc_mean_ap(jax_ap.build_records(names, dets, anns), use_07_metric=metric07)
    assert got == want and 0.0 < got[0] < 1.0


def test_devkit_files_are_byte_identical(tmp_path):
    dets, _ = _random_outputs(1)
    for d in dets:
        d["classes"] = d["classes"] * 5          # spread over the 20 VOC classes
    ours = voc_ap.write_voc_detection_files(VOC_CLASSES, dets, str(tmp_path / "ours"))
    theirs = jax_ap.write_voc_detection_files(VOC_CLASSES, dets, str(tmp_path / "theirs"))
    assert [Path(p).name for p in ours] == [Path(p).name for p in theirs]
    assert len(ours) == 20
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(ours, theirs))
    assert sum(Path(p).stat().st_size for p in ours) > 0


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    model = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    # 5 images in both orientation buckets: each bucket ends in a partial batch
    ds = SyntheticDetection(n=5, hw_range=((40, 90), (40, 90)), seed=3)
    return cfg, model, ds


def test_evaluator_detections_equal_the_port_detect(tiny):
    cfg, model, ds = tiny
    ev = Evaluator(model, cfg, ds, batch_size=2, score_thresh=0.0, device="cpu")
    got = {d["id"]: d for d in ev.collect_detections()}
    assert sorted(got) == ds.ids
    assert sum(ev.timing["batches"].values()) > len(ds) // 2    # partial batches padded
    assert len(ev.timing["batches"]) == 2                       # both buckets
    seen = set()
    with torch.inference_mode():
        for batch in DetectionLoader(ds, batch_size=2, image_cfg=cfg.image):
            info = upload(batch.im_info, torch.device("cpu"))
            dets = postprocess(model.eval().detect(upload(batch.images, torch.device("cpu")),
                                                   info), info, cfg, score_thresh=0.0)
            for i, iid in enumerate(batch.ids):
                if iid in seen:
                    continue
                seen.add(iid)
                v = dets.valid[i]
                for k, t in (("boxes", dets.boxes), ("scores", dets.scores),
                             ("classes", dets.classes)):
                    np.testing.assert_array_equal(got[iid][k], t[i][v].numpy(), err_msg=k)
    assert sum(len(d["scores"]) for d in got.values()) > 0
    out = ev(model)
    assert set(out) == ({"eval_mAP", "eval_seconds", "eval_images"}
                        | {f"eval_AP/{c}" for c in VOC_CLASSES[1:]})
    assert out["eval_images"] == 5.0
    assert out["eval_mAP"] == voc_ap.voc_mean_ap(voc_ap.build_records(
        VOC_CLASSES, list(got.values()), ev.annotations()))[0]
    with pytest.raises(ValueError):
        Evaluator(model, cfg, ds, metric="voc12", device="cpu")
    # the COCO metric over the same detections
    coco = Evaluator(model, cfg, ds, batch_size=2, score_thresh=0.0, metric="coco",
                     device="cpu")(model)
    assert set(coco) == {"eval_AP", "eval_AP50", "eval_AP75", "eval_seconds", "eval_images"}
    want = coco_eval(list(got.values()), ev.annotations(), len(VOC_CLASSES))
    assert (coco["eval_AP"], coco["eval_AP50"], coco["eval_AP75"]) == (
        want["AP"], want["AP50"], want["AP75"])


def test_ground_truth_from_detections_scores_alike_in_any_image_order(tiny):
    """chip_smoke's data-parallel evaluation check scores ground truth made
    from one process's detections (``gt_from_detections``): every
    detection is then a true or a false positive whatever the images'
    order, so the mAP of the list in any order of images (the ranks' merge
    orders them by rank) is the same, and above 0; the ground truth also
    holds boxes that no detection hits."""
    from chip_smoke import GroundTruthFrom, gt_from_detections

    cfg, model, ds = tiny
    dets = Evaluator(model, cfg, ds, batch_size=2, score_thresh=0.0,
                     device="cpu").collect_detections()
    gt, hit, missed = gt_from_detections(dets)
    assert hit > 0 and missed == 2
    scored = GroundTruthFrom(ds, gt)
    anns = {a["id"]: a for a in (scored.get_annotation(i) for i in range(len(scored)))}
    maps = {voc_ap.voc_mean_ap(voc_ap.build_records(VOC_CLASSES, order, anns))[0]
            for order in (dets, dets[::-1], dets[2:] + dets[:2])}
    assert len(maps) == 1 and maps.pop() > 0
    ev = Evaluator(model, cfg, scored, batch_size=2, score_thresh=0.0, device="cpu")
    assert ev(model)["eval_mAP"] == voc_ap.voc_mean_ap(voc_ap.build_records(
        VOC_CLASSES, dets, anns))[0]
    assert scored.get_example(3)["id"] == ds.get_example(3)["id"]
    assert scored.get_size(3) == ds.get_size(3) and len(scored) == len(ds)


@pytest.mark.parametrize("total,n_batches,want", [(3, 3, [2, 3]), (10, 3, [2, 3])],
                         ids=["last_step", "batches_run_out"])
def test_trainer_eval_hook_fires_every_n_steps_and_at_the_end(tiny, total, n_batches, want):
    """The hook gets the trained model; the trainer takes the loader's
    Batches."""
    cfg, model, ds = tiny
    calls = []

    def evaluator(m):
        calls.append(trainer.state.step)
        assert m is trainer.state.model
        return {"eval_mAP": 0.5, "eval_AP/cat": 0.25}

    loader = DetectionLoader(ds, batch_size=1, image_cfg=cfg.image, max_boxes=4)
    trainer = Trainer(copy.deepcopy(model), cfg,
                      TrainConfig(total_iters=total, log_every=5, eval_every=2),
                      device="cpu", evaluator=evaluator)
    state = trainer.fit(b for _, b in zip(range(n_batches), loader))
    assert state.step == 3 and calls == want
