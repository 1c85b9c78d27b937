"""K5_roi_align_roofline: K5's bound with bf16 crops
(bench_port.counts.roi_align_bound) over its summed device time per detect
call."""

from bench_port import readers


def read(trace):
    return readers.roofline_pct(trace, "detect", "roi_align_fwd", "k5")
