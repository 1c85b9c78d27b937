"""Run one cell of the port's benchmark once and print one JSON line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``bench_port/``
and the port (``trcnn_torch/``).  Exits 2, printing no result, without a
CUDA card or with fewer cards than the cell asks for; exits 3 if a module
of the JAX package, JAX or flax is loaded when the window has closed; 1 on
any other failure.  With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled sub-window.  Every number the check compares is printed beside
its limit, last on standard error and last in the line (``checks``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
# the cell's build and kernel caches live at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "trcnn")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: ``trcnn_torch`` is not ``trcnn``."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from bench_port import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: the cell needs {cell.chips} CUDA card(s), {n} found",
              file=sys.stderr)
        return 2
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS,
                      str(ROOT / "build" / "bench_port" / f"trace.{args.workload}.json"))
    found = forbidden_modules()
    if found:
        print(f"bench_port: modules loaded that the port may not load: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device, "traffic": res["traffic"]}
    for key in ("checked", "worst_leaf", "check_error", "readings"):
        if key in res:
            line[key] = res[key]
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, row in res["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
