"""Whole runs on the CPU at tiny sizes, the look for a card skipped: cells,
a configuration and a per-layer metric added by new files and manifest
entries alone; and each fault a cell can have, planted under the timed
path, turns ``correct`` false at the cells' own limits."""

import copy

import pytest
import torch

from bench_port import harness
from bench_port.tests import bench_port_tiny as tiny
from trcnn_torch.models import faster_rcnn
from trcnn_torch.train import step as step_mod

SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bench"),
                     cells=(("tiny_vgg", "detect"), ("tiny_vgg", "train")))


def run(root, name, traced=False):
    cell = harness.load_cell(root, name, root / "bench_port")
    return harness.run(cell, SEED, 0.2, traced, "cpu",
                       trace_path=str(root / "build" / "trace.json"))


def test_cells_config_and_metric_added_by_files(root):
    cell = harness.load_cell(root, "tiny_vgg.detect", root / "bench_port")
    assert tiny.EXTRA_METRIC in cell.per_layer
    assert set(cell.end_to_end) == {"detect_img_per_s", "detect_p95_ms", "peak_mem_gib",
                                    "setup_s"}
    res = run(root, "tiny_vgg.detect", traced=True)
    assert res["metrics"][tiny.EXTRA_METRIC]["value"] == 3.0
    assert res["correct"], res["checks"]
    res = run(root, "tiny_vgg.train")
    assert set(res["metrics"]) == {"train_img_per_s", "peak_mem_gib", "setup_s"}
    assert res["correct"], res["checks"]


def altered_postprocess(raw, im_info, cfg, score_thresh=None,
                        _real=faster_rcnn.postprocess):
    """The epilogue with its first detection's box moved by 2 px."""
    dets = _real(raw, im_info, cfg, score_thresh)
    boxes = dets.boxes.clone()
    boxes[0, 0] += 2.0
    return dets._replace(boxes=boxes)


def unchanged_step(state, batch, seed=0, _real=step_mod.train_step, **kw):
    """A step that computes everything and leaves the state as it was."""
    params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    momentum = copy.deepcopy(state.optimizer.momentum)
    out = _real(state, batch, seed, **kw)
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(params[k])
    state.optimizer.momentum.update(momentum)
    return out


def half_anchor_targets(*args, _real=faster_rcnn.anchor_targets, **kw):
    """Anchor targets with the second half of the batch ignored: the RPN
    runs over every image, its losses over the first half's anchors."""
    at = _real(*args, **kw)
    h = at.labels.shape[0] // 2
    labels, examples, fg = at.labels.clone(), at.num_examples.clone(), at.num_fg.clone()
    labels[h:], examples[h:], fg[h:] = -1, 0, 0
    return at._replace(labels=labels, num_examples=examples, num_fg=fg)


def half_proposal_targets(*args, _real=faster_rcnn.proposal_targets, **kw):
    """RoI targets with the second half of the batch's slots empty: the
    head runs over every RoI, its losses' means over the first half's."""
    pt = _real(*args, **kw)
    h = pt.labels.shape[0] // 2
    valid, is_fg, fg = pt.valid.clone(), pt.is_fg.clone(), pt.num_fg.clone()
    valid[h:], is_fg[h:], fg[h:] = False, False, 0
    return pt._replace(valid=valid, is_fg=is_fg, num_fg=fg)


# each fault: the names it replaces under the timed path; half_batch keeps
# every shape (the whole batch runs forward and backward), so that only the
# numbers compared can catch it
FAULTS = {
    "answer_altered": ((faster_rcnn, "postprocess", altered_postprocess),),
    "state_unchanged": ((step_mod, "train_step", unchanged_step),),
    "half_batch": ((faster_rcnn, "anchor_targets", half_anchor_targets),
                   (faster_rcnn, "proposal_targets", half_proposal_targets)),
}


def plant(monkeypatch, fault: str) -> None:
    for module, name, replacement in FAULTS[fault]:
        monkeypatch.setattr(module, name, replacement)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_vgg.detect", "answer_altered"),
    ("tiny_vgg.train", "state_unchanged"),
    ("tiny_vgg.train", "half_batch"),
], ids=["answer_altered", "state_unchanged", "half_batch"])
def test_each_fault_fails_the_check(root, monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    res = run(root, cell)
    assert "check_error" not in res, res["check_error"]
    assert not res["correct"], res["checks"]
