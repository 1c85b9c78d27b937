"""optimizer_launches.train: device operations (kernels, copies and sets)
per training step whose CUDA runtime launch starts inside the program's
``train_step.optimizer`` span (the global norm and the CaffeSGD update),
linked to their launch by the profiler's correlation id.  A count of
launches, so it carries none of the profiler's cost per operator."""

from bench_port.trace import DEVICE_CATEGORIES, RUNTIME_CATEGORIES, Trace

SPAN = "train_step.optimizer"


def read(trace: Trace):
    spans = [(s.start_us, s.end_us) for s in trace.spans(SPAN)]
    if trace.counts.get("kind") != "train" or not spans or not trace.span_calls:
        return None
    launches = {e.correlation: e.start_us for e in trace.span_events
                if e.cat in RUNTIME_CATEGORIES and e.correlation is not None}
    n = 0
    for e in trace.span_events:
        t = launches.get(e.correlation) if e.cat in DEVICE_CATEGORIES else None
        if t is not None and any(s <= t <= end for s, end in spans):
            n += 1
    return n / trace.span_calls
