"""K3_stem_roofline: K3's bound (bench_port.counts.stem_bound) over
its summed device time per detect call."""

from bench_port import readers


def read(trace):
    return readers.roofline_pct(trace, "detect", "stem_", "k3")
