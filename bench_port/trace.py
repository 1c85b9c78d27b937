"""The traced window: the profiler around it, its events as plain records,
the device's busy intervals, spans opened from module hooks, and the
attribution of device work to spans.

A run with ``--trace 1`` first times a sub-window of calls untraced (the
pace: seconds per call as a user's run takes them), then profiles two
bounded sub-windows of as many calls with ``torch.profiler``: the device
pass records the card's activity alone and gives the device's busy time
per call and the kernels' times; the span pass also records the host
(operators, the CUDA runtime, spans), and serves only the attribution of
device work to spans, the host spans' own durations and the naming of idle
gaps.  Even the device pass slows a host-paced call (the profiler's cost
per launch), so the shares of the step's time (mfu, idle) divide by the
untraced pace, not by the device pass's length.  Each chrome trace goes to the checkout's build
directory, is read back and deleted.  The per-layer readers
(``bench_port/metrics/<name>.py``) take their numbers from a
:class:`Trace` holding both.

Attribution: a device event (kernel, copy or set) belongs to the span in
whose host interval the CUDA runtime call that launched it started, linked
by the profiler's correlation id.  The profiler's operator tree is not
used: it links no operator to the kernels the port launches through
ctypes (K1-K6), which would drop out.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"
GAPS_NAMED = 200


class Event(NamedTuple):
    name: str
    cat: str
    start_us: float
    end_us: float
    correlation: Optional[int] = None
    tid: Optional[int] = None

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


class Trace(NamedTuple):
    """The two traced sub-windows: the device pass's events, its calls
    (detect calls or training steps) and its length by the host's clock
    (first issue to the final synchronize); the span pass's events and
    calls; the configuration's counts (:mod:`bench_port.counts` results
    the readers may use); and the untraced sub-window's seconds per call."""
    events: List[Event]
    calls: int
    window_s: float
    span_events: List[Event]
    span_calls: int
    counts: Dict[str, object]
    call_s: float

    def device(self) -> List[Event]:
        return [e for e in self.events if e.cat in DEVICE_CATEGORIES]

    def kernels(self, fragment: str = "") -> List[Event]:
        return [e for e in self.events if e.cat == "kernel" and fragment in e.name]

    def spans(self, name: str) -> List[Event]:
        return [e for e in self.span_events if e.cat == "user_annotation" and e.name == name]


def from_chrome(doc: dict) -> List[Event]:
    """The complete events ("ph" "X") of a chrome trace as records."""
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        args = e.get("args") or {}
        corr = args.get("correlation", args.get("correlation id"))
        ts = float(e["ts"])
        out.append(Event(e.get("name", ""), e.get("cat", ""), ts, ts + float(e["dur"]),
                         None if corr is None else int(corr), e.get("tid")))
    return out


def union_us(intervals: Sequence[Tuple[float, float]], lo: float = float("-inf"),
             hi: float = float("inf")) -> float:
    """The length of the union of intervals, each clipped to [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_us(trace: Trace) -> float:
    """Microseconds of the device pass in which a kernel, copy or set ran."""
    return union_us([(e.start_us, e.end_us) for e in trace.device()])


def attributed_us(trace: Trace, span: str) -> Optional[float]:
    """Device microseconds of the span pass's work launched inside the spans
    named ``span``: each device event's runtime launch (same correlation
    id) has to start inside one of the spans' host intervals.  None without
    such a span."""
    spans = sorted((s.start_us, s.end_us) for s in trace.spans(span))
    if not spans:
        return None
    launches = {e.correlation: e.start_us for e in trace.span_events
                if e.cat in RUNTIME_CATEGORIES and e.correlation is not None}
    total = 0.0
    for e in trace.span_events:
        if e.cat not in DEVICE_CATEGORIES:
            continue
        t = launches.get(e.correlation)
        if t is not None and any(s <= t <= end for s, end in spans):
            total += e.dur_us
    return total


def family(name: str) -> str:
    """A device event's family (``trcnn_torch.utils.profiling.kernel_family``,
    copied): a kernel's name without ``void``, namespaces, template
    arguments and parameters; a copy's or set's kind."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(", 1)[0].strip()
    base = name.removeprefix("void ").replace("(anonymous namespace)", "")
    return base.split("<", 1)[0].split("(", 1)[0].rsplit("::", 1)[-1].strip()


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List[List[object]]]:
    """The device families that took most seconds in the device pass, and
    the ``GAPS_NAMED`` longest idle gaps of the span pass summed by the host
    span (innermost user annotation or operator) running when each began."""
    ops: Dict[str, float] = {}
    for e in trace.device():
        ops[family(e.name)] = ops.get(family(e.name), 0.0) + e.dur_us / 1e6
    window = [e for e in trace.span_events if e.name == WINDOW_SPAN]
    dev = sorted((e for e in trace.span_events if e.cat in DEVICE_CATEGORIES),
                 key=lambda e: e.start_us)
    if not window or not dev:
        return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": []}
    lo, hi = window[0].start_us, window[0].end_us
    gaps = []
    cur = lo
    for e in dev:
        if e.start_us > cur:
            gaps.append((cur, e.start_us))
        cur = max(cur, e.end_us)
    if hi > cur:
        gaps.append((cur, hi))
    host = [e for e in trace.span_events if e.cat in ("user_annotation", "cpu_op")
            and e.name != WINDOW_SPAN]
    by_host: Dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        inner = [h for h in host if h.start_us <= s < h.end_us]
        name = min(inner, key=lambda h: h.dur_us).name if inner else "(no host span)"
        by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
    return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(by_host.items(),
                                                    key=lambda kv: -kv[1])[:top]]}


class SpanHooks:
    """``record_function`` spans around modules' forwards, opened by a
    forward pre-hook and closed by a forward hook; :meth:`remove` takes the
    hooks off."""

    def __init__(self, modules: Dict[str, object]):
        from torch.profiler import record_function

        self._handles, self._open = [], {}
        for name, module in modules.items():
            def pre(_m, _args, name=name):
                rf = record_function(name)
                rf.__enter__()
                self._open[name] = rf

            def post(_m, _args, _out, name=name):
                self._open.pop(name).__exit__(None, None, None)

            self._handles += [module.register_forward_pre_hook(pre),
                              module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


@contextlib.contextmanager
def profiled(path: str, host: bool) -> Iterator[List[Event]]:
    """Profile the block on the card and, with ``host``, on the host;
    afterwards the yielded list holds the trace's events.  The chrome trace
    goes through ``path``, which is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    events: List[Event] = []
    cuda = torch.cuda.is_available()
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield events
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events.extend(from_chrome(json.load(f)))
    finally:
        os.remove(path)
