"""The idle-share, span-attribution and reader arithmetic on synthetic
traces."""

import importlib.util
from pathlib import Path

import pytest

from bench_port import trace as tr

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ev(name, cat, s, e, corr=None):
    return tr.Event(name, cat, float(s), float(e), corr, 1)


def synthetic(kind="detect"):
    """A 100 us window of two calls: trunk spans at 0-20 and 50-70 launch
    kernels 1 and 3, head spans at 20-30 and 70-80 launch 2 and 4; kernel 5
    (a K3 stem kernel) launched in the first trunk span; a memset outside
    every span.  Device intervals overlap once (10-25 and 20-35)."""
    events = [ev(tr.WINDOW_SPAN, "user_annotation", 0, 100)]
    events += [ev(name, "user_annotation", s, e) for name, s, e in (
        ("bench.trunk", 0, 20), ("bench.trunk", 50, 70), ("bench.head", 20, 30),
        ("bench.head", 70, 80))]
    launches = {1: 5, 2: 22, 3: 55, 4: 75, 5: 6, 6: 90}
    events += [ev("cudaLaunchKernel", "cuda_runtime", t, t + 1, c) for c, t in launches.items()]
    events += [ev("void conv_kernel<1>(float*)", "kernel", 10, 25, 1),
               ev("gemm", "kernel", 20, 35, 2),
               ev("conv", "kernel", 60, 65, 3),
               ev("gemm", "kernel", 80, 84, 4),
               ev("void stem_bf16_tc_kernel(int)", "kernel", 40, 42, 5),
               ev("Memset (Device)", "gpu_memset", 95, 96, 6)]
    counts = {"kind": kind, "flops_per_call": 989e12 * 50e-6 / 2, "k3": {"bound_ms": 0.0005}}
    # the same events serve as the device pass (100 us by the host's clock)
    # and the span pass; a call takes 50 us untraced
    return tr.Trace(events, 2, 100e-6, events, 2, counts, 50e-6)


def test_union_and_idle_share():
    assert tr.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert tr.union_us([(0, 10), (5, 15)], lo=8, hi=12) == 4
    t = synthetic()
    # busy: 10-35 (25), 40-42, 60-65, 80-84, 95-96 -> 37 of 100, 18.5 us a call
    assert tr.busy_us(t) == 37
    assert reader("device_idle_pct.detect")(t) == pytest.approx(63.0)
    assert reader("device_idle_pct.train")(t) is None
    # the profiler slowed the host: a call takes 40 us untraced, so the
    # card idles 1 - 18.5 / 40 of a user's call, not 63% of the traced one
    slowed = t._replace(call_s=40e-6)
    assert reader("device_idle_pct.detect")(slowed) == pytest.approx(53.75)


def test_attribution_by_launch_inside_the_span():
    t = synthetic()
    # trunk: kernels 1 (15 us), 3 (5 us), the stem 5 (2 us); head: 2 (15), 4 (4)
    assert tr.attributed_us(t, "bench.trunk") == 22
    assert tr.attributed_us(t, "bench.head") == 19
    assert reader("trunk_device_ms.detect")(t) == pytest.approx(0.011)
    assert reader("head_device_ms.detect")(t) == pytest.approx(0.0095)
    assert tr.attributed_us(t, "no.such.span") is None


def test_mfu_roofline_and_spans():
    t = synthetic()
    # flops_per_call in 50 us a call = half of 989 TFLOP/s; by the untraced
    # pace, not the device pass's length
    assert reader("mfu.detect")(t) == pytest.approx(50.0)
    assert reader("mfu.detect")(t._replace(window_s=200e-6)) == pytest.approx(50.0)
    assert reader("mfu.detect")(t._replace(call_s=25e-6)) == pytest.approx(100.0)
    assert reader("mfu.train")(t) is None
    # the stem kernel: 2 us over 2 calls = 1 us a call against a 0.5 us bound
    assert reader("K3_stem_roofline")(t) == pytest.approx(50.0)
    assert reader("K5_roi_align_roofline")(t) is None
    span = t.span_events + [ev("train_step.optimizer", "user_annotation", 30, 36)]
    steps = tr.Trace(t.events, 2, 100e-6, span, 2, {"kind": "train"}, 50e-6)
    assert reader("optimizer_span_ms")(steps) == pytest.approx(0.003)


def test_chrome_events_and_breakdown():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>()",
         "ts": 1.5, "dur": 2.0, "args": {"correlation": 7}},
        {"ph": "i", "cat": "instant", "name": "x", "ts": 0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 10.0}]}
    events = tr.from_chrome(doc)
    assert [e.cat for e in events] == ["kernel", "cpu_op"]
    assert events[0].correlation == 7 and events[0].end_us == 3.5
    events.append(tr.Event(tr.WINDOW_SPAN, "user_annotation", 0.0, 12.0))
    b = tr.breakdown(tr.Trace(events, 1, 12e-6, events, 1, {}, 12e-6))
    assert b["device_ops"] == [["vectorized_elementwise_kernel", 2e-06]]
    assert b["idle_gaps"][0][0] == "aten::add"
    assert tr.family("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
