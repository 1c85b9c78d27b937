"""A copy of the benchmark in a temporary directory with tiny cells added
by files and manifest entries alone, for CPU rehearsals of whole runs."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_VGG = {"preset": "voc", "backbone": "vgg16", "roi_mode": "max", "dtype": "bfloat16",
            "batch_size": 2, "gt_capacity": 4, "source": "tiny", "reduced": [],
            "overrides": {"head_hidden": 64, "rpn_channels": 32,
                          "anchors": {"scales": [1.0, 2.0, 3.0]},
                          "proposals": {"pre_nms_topk_train": 192, "post_nms_topk_train": 48,
                                        "pre_nms_topk_test": 192, "post_nms_topk_test": 24},
                          "proposal_targets": {"rois_per_image": 16},
                          "image": {"target_min_size": 48, "target_max_size": 96,
                                    "pad_h": 64, "pad_w": 96}}}
TINY_R101 = {"preset": "coco", "backbone": "resnet101", "roi_mode": "align",
             "dtype": "bfloat16", "batch_size": 2, "gt_capacity": 4, "source": "tiny",
             "reduced": [],
             "overrides": {"rpn_channels": 64,
                           "anchors": {"scales": [2.0, 4.0, 8.0, 16.0, 32.0]},
                           "proposals": {"pre_nms_topk_train": 256, "post_nms_topk_train": 48,
                                         "pre_nms_topk_test": 256, "post_nms_topk_test": 24},
                           "proposal_targets": {"rois_per_image": 16},
                           "image": {"pad_h": 128, "pad_w": 192, "multiscale_min_sizes": []},
                           "test": {"max_dets_per_class": 32, "max_dets_per_image": 32}}}
IMAGE = {"tiny_vgg": {"orig_short": 48, "aspect": [1.0, 1.5], "min_size": 48, "max_size": 90},
         "tiny_r101": {"orig_short": 100, "aspect": [1.0, 1.5], "min_size": 110,
                       "max_size": 180}}
GT = {"counts": {"1": 0.5, "2": 0.3, "4": 0.2}, "side_lo": 0.2, "side_hi": 0.6}
# the tiny cells' limits (the tiny cells pool with max, as the VGG-16 cell
# does): the full cells' numbers, looser where a tiny random network's
# rounding reads higher; every fault still fails them
TINY_LIMITS = {"detect": {"feat_channels": 0.2, "proposals": 0, "crops": 0, "detections": 0},
               "train": {"grad": 0.1, "change": 0.1}}
# a per-layer metric added by a file of its own
EXTRA_METRIC = "calls_per_window.detect"
EXTRA_READER = '''"""calls_per_window.detect: detect calls in the traced window."""


def read(trace):
    return float(trace.calls) if trace.counts.get("kind") == "detect" else None
'''


def traffic(config: str, kind: str) -> dict:
    t = {"kind": kind, "image": IMAGE[config], "trace_calls": 3 if kind == "detect" else 2}
    if kind == "detect":
        t.update(pool_batches=3, warmup_calls=1, check={"within": 1})
    else:
        t.update(pool_batches=6, warmup_steps=1, gt=GT)
    return t


def tree(tmp: Path, cells=(("tiny_vgg", "detect"),)) -> Path:
    """A checkout in ``tmp``: BENCHMARK.json and bench_port copied, then for
    each (config, kind) a config file, a workload file, a limits file
    (TINY_LIMITS) and the manifest entries; every such detect cell also
    reports EXTRA_METRIC, whose reader is a new file.  Returns the root."""
    root = Path(tmp)
    bp = root / "bench_port"
    shutil.copytree(REPO / "bench_port", bp, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    (bp / "metrics" / f"{EXTRA_METRIC}.py").write_text(EXTRA_READER)
    extra = {"name": EXTRA_METRIC, "unit": "calls", "better": "higher",
             "source": "device_trace", "layer": "device", "moves": "detect_img_per_s",
             "workloads": []}
    man["per_layer"].append(extra)
    for config in sorted({c for c, _ in cells}):
        conf = TINY_VGG if config == "tiny_vgg" else TINY_R101
        (bp / "configs" / f"{config}.json").write_text(json.dumps(conf))
        man["configs"].append({"name": config, "source": "https://arxiv.org/abs/1506.01497",
                               "file": f"bench_port/configs/{config}.json", "reduced": [],
                               "why": "a tiny rehearsal configuration"})
    for config, kind in cells:
        name = f"{config}.{kind}"
        (bp / "workloads" / f"{name}.json").write_text(json.dumps(traffic(config, kind)))
        big = "vgg16_voc" if config == "tiny_vgg" else "r101_c4_coco"
        (bp / "limits" / f"{name}.json").write_text(json.dumps({"limits": TINY_LIMITS[kind]}))
        man["workloads"].append({"name": name, "config": config, "traffic": kind, "chips": 1,
                                 "why": "a tiny rehearsal cell"})
        for m in man["end_to_end"] + man["per_layer"]:
            if f"{big}.{kind}_b8" in m.get("workloads", ()):
                m["workloads"].append(name)
        if kind == "detect":
            extra["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root

