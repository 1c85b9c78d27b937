"""device_idle_pct.detect: the share of an untraced detect call's seconds in
which no kernel, copy or set runs on the card: 1 - the device pass's busy
time per call over the untraced seconds per call."""

from bench_port import readers


def read(trace):
    return readers.idle_pct(trace, "detect")
