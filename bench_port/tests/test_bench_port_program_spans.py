"""The readers of the program's own spans on synthetic traces: the five
detect stages' device ms, the host reads a call and the optimizer's
launches a step."""

import importlib.util
from pathlib import Path

import pytest

from bench_port import trace as tr

METRICS = Path(__file__).resolve().parents[1] / "metrics"
STAGE_READERS = {"prepare_device_ms.detect": "frcnn.prepare",
                 "rpn_device_ms.detect": "frcnn.rpn",
                 "proposal_device_ms.detect": "frcnn.proposals",
                 "pool_device_ms.detect": "frcnn.pool",
                 "epilogue_device_ms.detect": "frcnn.postprocess"}
NEW = (*STAGE_READERS, "host_reads.detect", "optimizer_launches.train")


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ev(name, cat, s, e, corr=None):
    return tr.Event(name, cat, float(s), float(e), corr, 1)


def detect_trace(with_program_spans=True):
    """Two calls of 50 us.  In each, the five stages at 10 us apiece launch
    one kernel of (stage index + 1) us each; the epilogue holds one
    ``host_read.nms.valid_prefix`` span; a copy to the host (the harness's)
    is launched after the epilogue, outside every span."""
    events = [ev(tr.WINDOW_SPAN, "user_annotation", 0, 100)]
    corr = 0
    for call in range(2):
        t0 = 50 * call
        for i, span in enumerate(STAGE_READERS.values()):
            s = t0 + 10 * i
            if with_program_spans:
                events.append(ev(span, "user_annotation", s, s + 9))
            corr += 1
            events += [ev("cudaLaunchKernel", "cuda_runtime", s + 1, s + 2, corr),
                       ev("kernel", "kernel", s + 2, s + 3 + i, corr)]
        if with_program_spans:
            events.append(ev("host_read.nms.valid_prefix", "user_annotation", t0 + 45, t0 + 47))
        corr += 1
        events += [ev("cudaMemcpyAsync", "cuda_runtime", t0 + 49.5, t0 + 49.7, corr),
                   ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t0 + 49.6, t0 + 50, corr)]
    return tr.Trace(events, 2, 100e-6, events, 2, {"kind": "detect"}, 50e-6)


def train_trace(span=True):
    """Two steps of 50 us; the optimizer span of each (30-45) launches a
    kernel, a copy and a set; a kernel launched at 20, before the span,
    runs inside the span's interval on the device; a kernel launched at 46,
    after it, is not the optimizer's."""
    events = [ev(tr.WINDOW_SPAN, "user_annotation", 0, 100)]
    corr = 0
    for step in range(2):
        t0 = 50 * step
        if span:
            events.append(ev("train_step.optimizer", "user_annotation", t0 + 30, t0 + 45))
        for launch, cat, name in ((20, "kernel", "conv"), (31, "kernel", "mul"),
                                  (33, "gpu_memcpy", "Memcpy DtoD (Device -> Device)"),
                                  (35, "gpu_memset", "Memset (Device)"), (46, "kernel", "add")):
            corr += 1
            events += [ev("cudaLaunchKernel", "cuda_runtime", t0 + launch, t0 + launch + 0.5,
                          corr),
                       ev(name, cat, t0 + max(launch, 32), t0 + max(launch, 32) + 1, corr)]
    return tr.Trace(events, 2, 100e-6, events, 2, {"kind": "train"}, 50e-6)


def test_stage_readers_attribute_each_stage_per_call():
    t = detect_trace()
    for i, name in enumerate(STAGE_READERS):
        # one kernel of (i + 1) us a call
        assert reader(name)(t) == pytest.approx((i + 1) / 1e3), name
    # every device operation but the harness's copy to the host lies in a stage
    staged = sum(tr.attributed_us(t, s) for s in STAGE_READERS.values())
    assert staged + sum(e.dur_us for e in t.span_events if e.cat == "gpu_memcpy") == sum(
        e.dur_us for e in t.device())


def test_host_reads_a_call_divide_by_the_span_pass_calls():
    t = detect_trace()
    assert reader("host_reads.detect")(t) == 1.0
    assert reader("host_reads.detect")(t._replace(span_calls=4)) == 0.5
    # instrumented, with no read left: 0, not silence
    no_reads = [e for e in t.span_events if not e.name.startswith("host_read.")]
    assert reader("host_reads.detect")(t._replace(span_events=no_reads)) == 0.0


def test_optimizer_launches_count_kernels_copies_and_sets_launched_inside():
    t = train_trace()
    # per step: mul, the copy and the set; not the conv launched before the
    # span (though it runs inside it) nor the add launched after it
    assert reader("optimizer_launches.train")(t) == 3.0
    assert reader("optimizer_launches.train")(t._replace(span_calls=1)) == 6.0


@pytest.mark.parametrize("name", NEW)
def test_new_readers_are_silent_for_the_other_kind_and_without_their_span(name):
    is_train = name.endswith(".train")
    own, other = (train_trace(), detect_trace()) if is_train else (detect_trace(),
                                                                  train_trace())
    assert reader(name)(own) is not None
    assert reader(name)(other._replace(counts=own.counts)) is None
    assert reader(name)(own._replace(counts=other.counts)) is None
    bare = train_trace(span=False) if is_train else detect_trace(with_program_spans=False)
    assert reader(name)(bare) is None
    assert reader(name)(own._replace(span_calls=0)) is None
