"""proposal_device_ms.detect: device ms per detect call of the work launched
inside the program's ``frcnn.proposals`` span (the proposal layer: anchor
decode, clip, top-k and NMS on K1)."""

from bench_port import readers


def read(trace):
    return readers.span_device_ms(trace, "detect", "frcnn.proposals")
