"""trunk_device_ms.detect: device ms per detect call of the work launched
inside the span the benchmark opens around ``model.extractor`` (the VGG-16
or ResNet-101-C4 trunk, K3 included)."""

from bench_port import readers


def read(trace):
    return readers.span_device_ms(trace, "detect", "bench.trunk")
