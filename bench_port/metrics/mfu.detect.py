"""mfu.detect: the detect call's model operations (bench_port.counts) over
the seconds a call takes untraced (a sub-window of the traced run timed
without the profiler), as a share of the H100's bf16 dense peak."""

from bench_port import readers


def read(trace):
    return readers.mfu(trace, "detect")
