"""K6_roi_align_bwd_roofline: K6's bound with a bf16 crop gradient
(bench_port.counts.roi_align_bwd_bound) over its summed device time per
training step."""

from bench_port import readers


def read(trace):
    return readers.roofline_pct(trace, "train", "roi_align_bwd", "k6")
