"""The port's instrumentation (``trcnn_torch.utils.profiling``) on the CPU.

- ``span``: with no profiler it is one shared do-nothing context manager
  that enters no ``record_function``; under ``torch.profiler`` it is a
  ``user_annotation`` in the chrome trace;
- ``host_read``: returns the read's value, counts its site once a call and
  runs inside its own span under a profiler;
- the model's stage spans at ``__graft_entry__._tiny_cfg``: one ``detect`` +
  ``postprocess`` call opens each of the seven ``frcnn.*`` detect stages
  once, in order, and every operator the two functions run lies inside
  one of them (the CPU's view of the stages tiling the call); one
  ``losses`` call opens the training stages and ``frcnn.targets``.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from __graft_entry__ import _tiny_cfg
from trcnn_torch.models import make_model
from trcnn_torch.models.faster_rcnn import postprocess
from trcnn_torch.utils import profiling
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)

DETECT_STAGES = ("frcnn.prepare", "frcnn.trunk", "frcnn.rpn", "frcnn.proposals", "frcnn.pool",
                 "frcnn.head", "frcnn.postprocess")
TRAIN_STAGES = ("frcnn.prepare", "frcnn.trunk", "frcnn.rpn", "frcnn.proposals", "frcnn.targets",
                "frcnn.pool", "frcnn.head")
CALL = "test.call"


def traced(tmp_path, fn):
    """Run ``fn`` inside the span ``test.call`` under the CPU profiler;
    returns fn's result and the chrome trace's complete events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    return out, events


def annotations(events, prefix):
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda e: e["ts"])


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second
    with first:
        with second:
            pass
    assert profiling.host_read(lambda: 5, "test.no_profiler") == 5


def test_span_is_a_user_annotation_under_the_profiler(tmp_path):
    def call():
        with profiling.span("test.span"):
            return torch.ones(4).sum()

    _, events = traced(tmp_path, call)
    spans = [e for e in events if e["name"] == "test.span"]
    assert len(spans) == 1 and spans[0]["cat"] == "user_annotation"
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::sum"]
    assert ops and spans[0]["ts"] <= ops[0]["ts"] <= spans[0]["ts"] + spans[0]["dur"]


def test_host_read_returns_the_value_and_counts_its_site(tmp_path):
    profiling.reset_counters()
    t = torch.tensor([3, 9, 4])
    assert profiling.host_read(lambda: int(t.max()), "test.site") == 9
    assert profiling.counters["host_read.test.site"] == 1
    value, events = traced(tmp_path, lambda: profiling.host_read(t.tolist, "test.site"))
    assert value == [3, 9, 4]
    assert profiling.counters["host_read.test.site"] == 2
    assert [e["name"] for e in annotations(events, "host_read.")] == ["host_read.test.site"]
    profiling.reset_counters()
    assert profiling.counters["host_read.test.site"] == 0 and not profiling.counters


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg()
    model = make_model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    images = torch.randint(0, 256, (2, cfg.image.pad_h, cfg.image.pad_w, 3), dtype=torch.uint8,
                           generator=g)
    im_info = torch.tensor([[60.0, 92.0, 1.0], [48.0, 80.0, 1.0]])
    return cfg, model, images, im_info


def test_detect_stages_tile_detect_and_postprocess(tiny, tmp_path):
    cfg, model, images, im_info = tiny
    profiling.reset_counters()

    def call():
        with torch.no_grad():
            return postprocess(model.eval().detect(images, im_info), im_info, cfg)

    dets, events = traced(tmp_path, call)
    assert dets.boxes.shape[0] == 2
    stages = annotations(events, "frcnn.")
    assert [e["name"] for e in stages] == list(DETECT_STAGES)
    # one epilogue read, inside the epilogue's span
    reads = annotations(events, "host_read.")
    post = stages[-1]
    assert [e["name"] for e in reads] == ["host_read.nms.valid_prefix"]
    assert post["ts"] <= reads[0]["ts"] and reads[0]["ts"] + reads[0]["dur"] <= (
        post["ts"] + post["dur"])
    assert profiling.counters["host_read.nms.valid_prefix"] == 1
    # every operator of the call starts inside exactly one stage
    call_span = next(e for e in events if e["name"] == CALL)
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and call_span["ts"] <= e["ts"] <= call_span["ts"] + call_span["dur"]]
    assert ops
    outside = [e["name"] for e in ops
               if sum(s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in stages) != 1]
    assert outside == []


def test_losses_open_the_training_stages(tiny, tmp_path):
    cfg, model, images, im_info = tiny
    gt_boxes = torch.tensor([[[4.0, 6.0, 40.0, 50.0], [30.0, 10.0, 80.0, 44.0]],
                             [[10.0, 8.0, 60.0, 40.0], [0.0, 0.0, 0.0, 0.0]]])
    gt_labels = torch.tensor([[3, 7], [12, 0]], dtype=torch.int32)
    gt_valid = torch.tensor([[True, True], [True, False]])
    out, events = traced(tmp_path, lambda: model.train().losses(
        images, im_info, gt_boxes, gt_labels, gt_valid, torch.Generator().manual_seed(6)))
    assert torch.isfinite(out["loss"])
    assert [e["name"] for e in annotations(events, "frcnn.")] == list(TRAIN_STAGES)
