"""mfu.train: the training step's model operations (forward, weight and
input gradients; bench_port.counts) over the seconds a step takes
untraced (a sub-window of the traced run timed without the profiler), as a
share of the H100's bf16 dense peak."""

from bench_port import readers


def read(trace):
    return readers.mfu(trace, "train")
