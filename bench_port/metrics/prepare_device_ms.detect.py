"""prepare_device_ms.detect: device ms per detect call of the work launched
inside the program's ``frcnn.prepare`` span (the uint8 canvas cast, mean
subtraction and pad mask of ``FasterRCNN._prepare``)."""

from bench_port import readers


def read(trace):
    return readers.span_device_ms(trace, "detect", "frcnn.prepare")
