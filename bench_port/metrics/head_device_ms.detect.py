"""head_device_ms.detect: device ms per detect call of the work launched
inside the span the benchmark opens around ``model.head`` (fc6/fc7 and the
outputs, or res5 and the outputs)."""

from bench_port import readers


def read(trace):
    return readers.span_device_ms(trace, "detect", "bench.head")
