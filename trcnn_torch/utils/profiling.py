"""Timing and profiling harnesses (port of ``trcnn/utils/profiling.py``).

- :func:`time_fn`: the median wall time of a call, its device's work
  included (:func:`device_sync`);
- :func:`trace_to`: ``torch.profiler`` around a block, its chrome trace
  written under a directory;
- :func:`op_time_breakdown`: the device kernels' time per step in the
  newest such trace, by kernel family;
- :func:`span`: the program's named stages, a ``record_function`` while a
  profiler records and nothing otherwise;
- :data:`counters`: the port's one counter table: each kernel launch
  (``launch.<kernel>``) and each deliberate device-to-host read
  (:func:`host_read`, ``host_read.<site>``).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# chrome-trace categories of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# counts by name since the last reset_counters(), in this process
counters: collections.Counter = collections.Counter()
_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A named span around a stage: ``record_function(name)`` while a
    profiler records (``trace_to`` or any other caller of
    ``torch.profiler``), on the profiler's clock, so that every device
    operation launched inside it, and every idle gap that begins inside
    it, can be put down to it.  With no profiler it is one shared context
    manager that does nothing: one flag read, no allocation, no
    dispatcher call."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return record_function(name)


def count(name: str) -> None:
    counters[name] += 1


def reset_counters() -> None:
    counters.clear()


def host_read(fn: Callable, site: str):
    """``fn()``, one deliberate device-to-host read (``int(t)``,
    ``t.item()``, ``t.tolist()``), counted as ``host_read.<site>`` and,
    while a profiler records, run inside the span of that name; returns
    what ``fn`` returns."""
    name = "host_read." + site
    counters[name] += 1
    with span(name):
        return fn()


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def device_sync(out):
    """Wait for the device of ``out``'s first tensor (dicts, lists and
    tuples are searched) to finish its work; returns ``out``."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return out


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Tuple[float, object]:
    """Median wall seconds per call of ``fn(*args)`` (each call waited for
    on its device) over ``iters`` calls after one call and ``warmup`` more,
    and the last output."""
    out = device_sync(fn(*args))
    for _ in range(warmup):
        device_sync(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = device_sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


@contextlib.contextmanager
def trace_to(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host ops, and the card's kernels when there is
    one) and write its chrome trace to ``<logdir>/<ns>.pt.trace.json``;
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{time.time_ns()}.pt.trace.json"))


def kernel_family(name: str) -> str:
    """A device event's family: a kernel's name without ``void``, its
    namespaces, template arguments and parameters
    (``void at::native::vectorized_elementwise_kernel<4, ...>(...)`` ->
    ``vectorized_elementwise_kernel``); a copy's or set's kind (``Memcpy
    HtoD``)."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(", 1)[0].strip()
    base = name.removeprefix("void ").replace("(anonymous namespace)", "")
    return base.split("<", 1)[0].split("(", 1)[0].rsplit("::", 1)[-1].strip()


def op_time_breakdown(logdir: str, steps: int = 1) -> Dict[str, float]:
    """Milliseconds per step of the device's work in the newest chrome
    trace under ``logdir`` (``*.json`` or ``*.json.gz``), by
    :func:`kernel_family`, most first.  Host events are left out: a trace
    of the CPU alone gives {}."""
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pattern), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    newest = max(paths, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as f:
        events = json.load(f)["traceEvents"]
    agg: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATEGORIES:
            agg[kernel_family(e["name"])] += e["dur"]
    return {k: v / steps / 1000.0 for k, v in agg.most_common()}
