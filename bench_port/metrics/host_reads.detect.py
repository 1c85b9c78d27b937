"""host_reads.detect: the program's deliberate device-to-host reads per
detect call in the span pass, counted by their ``host_read.<site>`` spans.
None where the program opens no ``frcnn.*`` stage span, which a program
without its own instrumentation does not."""

from bench_port.trace import Trace


def read(trace: Trace):
    names = [e.name for e in trace.span_events if e.cat == "user_annotation"]
    if trace.counts.get("kind") != "detect" or not trace.span_calls or not any(
            n.startswith("frcnn.") for n in names):
        return None
    return sum(n.startswith("host_read.") for n in names) / trace.span_calls
