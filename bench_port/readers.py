"""The arithmetic the per-layer readers share.  Each reader returns None
where the traced window holds nothing for it (another kind of cell, a
kernel that did not run, a span that was not opened), and the harness then
leaves its metric out of the line."""

from __future__ import annotations

from typing import Optional

from bench_port import counts
from bench_port.trace import Trace, attributed_us, busy_us


def mfu(trace: Trace, kind: str) -> Optional[float]:
    """The model's operations per call over the untraced seconds per call,
    as a share of the bf16 dense peak."""
    if trace.counts.get("kind") != kind or not trace.calls:
        return None
    return trace.counts["flops_per_call"] / trace.call_s / counts.BF16_OPS_PER_S * 100.0


def idle_pct(trace: Trace, kind: str) -> Optional[float]:
    """1 - the device pass's busy seconds per call over the untraced
    seconds per call, in %."""
    if trace.counts.get("kind") != kind or not trace.device() or not trace.calls:
        return None
    return (1.0 - busy_us(trace) / 1e6 / trace.calls / trace.call_s) * 100.0


def span_device_ms(trace: Trace, kind: str, span: str) -> Optional[float]:
    if trace.counts.get("kind") != kind or not trace.span_calls:
        return None
    us = attributed_us(trace, span)
    return None if us is None else us / trace.span_calls / 1e3


def host_span_ms(trace: Trace, kind: str, span: str) -> Optional[float]:
    """A host span's ms per call in the span pass, the profiler's cost per
    host operator included."""
    spans = trace.spans(span)
    if trace.counts.get("kind") != kind or not spans or not trace.span_calls:
        return None
    return sum(s.dur_us for s in spans) / trace.span_calls / 1e3


def roofline_pct(trace: Trace, kind: str, fragment: str, bound: str) -> Optional[float]:
    """The kernel's bound over its summed device time per call, in %."""
    kernels = trace.kernels(fragment)
    b = trace.counts.get(bound)
    if trace.counts.get("kind") != kind or not kernels or b is None or not trace.calls:
        return None
    ms = sum(k.dur_us for k in kernels) / trace.calls / 1e3
    return b["bound_ms"] / ms * 100.0
