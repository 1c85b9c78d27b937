"""device_idle_pct.train: the share of an untraced training step's seconds
in which no kernel, copy or set runs on the card: 1 - the device pass's
busy time per step over the untraced seconds per step."""

from bench_port import readers


def read(trace):
    return readers.idle_pct(trace, "train")
