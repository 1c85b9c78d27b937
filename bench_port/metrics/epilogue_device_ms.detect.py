"""epilogue_device_ms.detect: device ms per detect call of the work launched
inside the program's ``frcnn.postprocess`` span (decode, clip, the
per-class NMS on K1 and its one read back to the host)."""

from bench_port import readers


def read(trace):
    return readers.span_device_ms(trace, "detect", "frcnn.postprocess")
