"""pool_device_ms.detect: device ms per detect call of the work launched
inside the program's ``frcnn.pool`` span (the RoI max pool K2 or RoIAlign
K5)."""

from bench_port import readers


def read(trace):
    return readers.span_device_ms(trace, "detect", "frcnn.pool")
