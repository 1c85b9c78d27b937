"""rpn_device_ms.detect: device ms per detect call of the work launched
inside the program's ``frcnn.rpn`` span (the RPN head's conv and its two
outputs)."""

from bench_port import readers


def read(trace):
    return readers.span_device_ms(trace, "detect", "frcnn.rpn")
