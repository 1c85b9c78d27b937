"""The port's profiling and debug utilities (``trcnn_torch.utils``) and its
native host ops (``trcnn_torch.ops.native``) on the CPU.

- ``time_fn``: the median of the timed calls and the last output;
  ``op_time_breakdown``: on a chrome trace that ``trace_to`` recorded here
  (the CPU alone: no device work, so {}), and on a hand-written trace with
  device kernel, copy and host events (ms per step by kernel family, host
  events left out, the newest file read); ``nan_debug``: a NaN made in a
  backward raises, and the setting is restored after;
- the native ops (the twins of tests/test_native.py): NMS equal to the
  JAX package's numpy oracle and to the port's plain NMS, the IoU matrix
  within 1e-5 of JAX's and of the port's ``box_iou``, the RoI pool equal to
  the numpy oracle and to the port's plain pool; a library that does not
  build makes ``available()`` False and every op raise with the
  compiler's message.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

from tests.conftest import random_boxes
from trcnn_torch.ops import native
from trcnn_torch.utils import nan_debug, op_time_breakdown, time_fn, trace_to
from tests.test_torch_package import torch_threads  # noqa: F401,E402  (autouse)


def test_time_fn_median_and_last_output():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep((0.0, 0.01, 0.04)[len(calls) % 3])
        return {"out": torch.full((2,), float(len(calls)))}

    secs, out = time_fn(fn, 1, iters=5, warmup=1)
    assert len(calls) == 1 + 1 + 5
    assert torch.equal(out["out"], torch.full((2,), 7.0))
    # timed calls 3..7 sleep 0, 10, 40, 0, 10 ms: the median is 10 ms
    assert 0.01 <= secs < 0.04


def test_op_time_breakdown_of_a_trace_to_trace(tmp_path):
    with trace_to(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")
    events = json.load(open(tmp_path / names[0]))["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert prof.key_averages() is not None
    assert op_time_breakdown(str(tmp_path)) == {}
    with pytest.raises(FileNotFoundError):
        op_time_breakdown(str(tmp_path / "empty"))


def test_op_time_breakdown_groups_device_kernels(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel"
         "<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
         "at::native::FillFunctor<float>, std::array<char*, 1ul>)", "dur": 300.0, "ts": 0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel"
         "<2, at::native::CUDAFunctor_add<float> >(int)", "dur": 100.0, "ts": 400},
        {"ph": "X", "cat": "kernel", "name": "trcnn_nms_kernel", "dur": 500.0, "ts": 600},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::roi_pool_fwd<__nv_bfloat16>"
         "(float const*)", "dur": 50.0, "ts": 1200},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "dur": 20.0,
         "ts": 1300},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9000.0, "ts": 0},
        {"ph": "X", "cat": "kernel", "name": "trcnn_nms_kernel", "ts": 2000},   # no duration
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
    ]
    old = tmp_path / "old.pt.trace.json"
    old.write_text(json.dumps({"traceEvents": [{"ph": "X", "cat": "kernel", "name": "x",
                                                "dur": 1.0}]}))
    os.utime(old, (1, 1))
    with gzip.open(tmp_path / "new.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    got = op_time_breakdown(str(tmp_path), steps=2)
    assert got == {"trcnn_nms_kernel": 0.25, "vectorized_elementwise_kernel": 0.2,
                   "roi_pool_fwd": 0.025, "Memcpy HtoD": 0.01}
    assert list(got) == ["trcnn_nms_kernel", "vectorized_elementwise_kernel", "roi_pool_fwd",
                         "Memcpy HtoD"]


def test_nan_debug_raises_on_a_nan_made_in_backward():
    def run():
        x = torch.zeros(3, requires_grad=True)
        y = (torch.sqrt(x) * 0.0).sum()        # finite forward; 0 * inf in SqrtBackward
        y.backward()
        return x.grad

    assert torch.isnan(run()).all()
    before = torch.is_anomaly_enabled()
    with nan_debug():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            run()
    assert torch.is_anomaly_enabled() == before


# ---------------------------------------------------------------- native


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.fail("the native library did not build: " + str(native._error))


def test_native_nms_matches_oracle_and_plain(built):
    from trcnn.ops.nms import nms_oracle_numpy

    for seed in range(3):
        r = np.random.RandomState(seed)
        boxes = random_boxes(r, 400)
        scores = r.rand(400).astype(np.float32)
        got = native.nms_cpu(boxes, scores, 0.5)
        assert got == nms_oracle_numpy(boxes, scores, 0.5) == native.nms_plain(boxes, scores, 0.5)
        assert native.nms_cpu(boxes, scores, 0.5, max_out=7) == got[:7]
        assert native.nms_plain(boxes, scores, 0.5, max_out=7) == got[:7]


def test_native_overlaps_match_jax_and_plain(built):
    import jax.numpy as jnp

    from trcnn.ops.boxes import box_iou

    rng = np.random.RandomState(1)
    a, b = random_boxes(rng, 50), random_boxes(rng, 30)
    got = native.bbox_overlaps_cpu(a, b)
    np.testing.assert_allclose(got, np.asarray(box_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, native.bbox_overlaps_plain(a, b), rtol=1e-5, atol=1e-6)


def test_native_roi_pool_matches_oracle_and_plain(built):
    from trcnn.ops.roi_pool import roi_max_pool_oracle_numpy

    rng = np.random.RandomState(2)
    feat = rng.randn(38, 63, 16).astype(np.float32)
    rois = random_boxes(rng, 40, im_w=1000, im_h=600)
    got = native.roi_max_pool_cpu(feat, rois)
    np.testing.assert_array_equal(got, roi_max_pool_oracle_numpy(feat, rois))
    np.testing.assert_array_equal(got, native.roi_max_pool_plain(feat, rois))
    # shapes are checked before a pointer reaches the library
    with pytest.raises(ValueError, match="boxes"):
        native.roi_max_pool_cpu(feat, np.zeros((3, 5), np.float32))
    with pytest.raises(ValueError, match="features"):
        native.roi_max_pool_cpu(feat[None], rois)
    with pytest.raises(ValueError, match="scores"):
        native.nms_cpu(rois, np.zeros(3, np.float32), 0.5)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile: ``available()`` is False, every op
    raises with g++'s message, and the source directory stays clean."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "detection_ops.cc").write_text("int broken( {\n")
    (src / "Makefile").write_text((native.SRC_DIR / "Makefile").read_text())
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available() is False
    boxes = random_boxes(np.random.RandomState(0), 4)
    for call in (lambda: native.nms_cpu(boxes, np.ones(4, np.float32), 0.5),
                 lambda: native.bbox_overlaps_cpu(boxes, boxes),
                 lambda: native.roi_max_pool_cpu(np.zeros((4, 4, 1), np.float32), boxes)):
        with pytest.raises(RuntimeError, match="(?s)build failed.*error"):
            call()
    assert sorted(os.listdir(src)) == ["Makefile", "detection_ops.cc"]
