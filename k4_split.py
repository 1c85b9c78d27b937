#!/usr/bin/env python3
"""Where kernel K4's time goes on the card (one NVIDIA GPU).

    python3 k4_split.py

Builds ``trcnn_torch/csrc/roi_pool_bwd.cu`` as it ships and four variants
of it, each with one more part of the work taken out by a text substitution
of the shipped source (so they follow it; a substitution that no longer
applies stops the script), and times each at the training shape: B=8 x 128
RoIs (``chip_smoke.roi_case``), 7x7 bins, a 38 x 64 x 512 bf16 map.

- ``shipped``: the kernel;
- ``plain adds``: each float atomic add into the slab replaced by a plain
  read, add and write (lanes then race: only its time means anything);
- ``no walk``: as ``plain adds``, and each bin reads only its first cell;
- ``no g``: as ``no walk``, and g is a constant instead of a load;
- ``frame``: no work items at all: the slice copy, the slab's zeroing, the
  RoI ranges and the write-out.

Consecutive differences are the parts' costs: the compare-and-swap loops of
the atomic adds, the walk, the loads of g, and the items' own work.  Times
are ``chip_smoke.cuda_time_ms``'s: CUDA events around 20 back-to-back
launches after a warm-up.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from chip_smoke import cuda_time_ms, roi_case

SRC = Path(__file__).resolve().parent / "trcnn_torch" / "csrc"
OUT = Path(__file__).resolve().parent / "build" / "k4_split"
ATOMIC = "atomicAdd(slab + slab_index<V>(w, v * V + k, cc), gv[k]);"
WALK = "const int bh = he - hs, n = (we - ws) * bh;"
GLOAD = "load_lanes<T, V>(gp, gv);"
ITEM = "      accumulate_bin<T, V, kGlobal>(ranges + rr * 4 * P,"
# each variant: the substitutions of the one before it and one more
STEPS = (("shipped", None),
         ("plain adds", (ATOMIC, "slab[slab_index<V>(w, v * V + k, cc)] += gv[k];")),
         ("no walk", (WALK, "const int bh = he - hs, n = 1;")),
         ("no g", (GLOAD, "for (int k = 0; k < V; ++k) gv[k] = 1.0f;")),
         ("frame", (ITEM, "      if (R < 0) accumulate_bin<T, V, kGlobal>(ranges + rr * 4 * P,")))


def build(nvcc: str, flags) -> dict:
    """Write and compile every variant in parallel; name -> library path."""
    src = (SRC / "roi_pool_bwd.cu").read_text()
    procs = {}
    for i, (name, sub) in enumerate(STEPS):
        if sub is not None:
            if sub[0] not in src:
                raise SystemExit(f"k4_split: '{sub[0]}' is no longer in roi_pool_bwd.cu")
            src = src.replace(sub[0], sub[1])
        d = OUT / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "roi_pool_bwd.cu").write_text(src)
        shutil.copy(SRC / "roi_bins.cuh", d)
        so = d / "libroi_pool_bwd.so"
        procs[name] = (subprocess.Popen([nvcc, *flags, "-o", str(so), str(d / "roi_pool_bwd.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    for name, (proc, _) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k4_split: {name} failed to build:\n{log}")
    return {name: so for name, (_, so) in procs.items()}


def main() -> int:
    import torch

    from trcnn_torch import _build
    from trcnn_torch.ops import roi_pool

    if not torch.cuda.is_available():
        print("k4_split.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    libs = build(_build._nvcc(), _build.NVCC_FLAGS)

    feat, rois = roi_case(8, 128, 30)
    g = np.random.default_rng(31).standard_normal((8, 128, 7, 7, 512))
    feat_t = torch.from_numpy(feat).to(dev, torch.bfloat16)
    rois_t = torch.from_numpy(rois).to(dev)
    g_t = torch.from_numpy(g).to(dev, torch.bfloat16)
    b, h, w, c = feat_t.shape
    large, cc, rows, smem = roi_pool._bwd_plan(h, w, feat_t.element_size())
    assert not large
    out = torch.empty_like(feat_t)
    stream = _build.stream_of(dev)

    ms = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).trcnn_roi_pool_bwd
        fn.argtypes = roi_pool._BWD_ARGTYPES

        def run(fn=fn):
            err = fn(_build.ptr(feat_t), _build.ptr(rois_t), _build.ptr(g_t), b, 128, h, w, c, 7,
                     1 / 16, 1, cc, rows, smem, _build.ptr(out), stream)
            _build.check(err, "k4_split")

        ms[name] = cuda_time_ms(run, iters=20)
    names = [s[0] for s in STEPS]
    parts = ("atomic adds (compare-and-swap loops)", "walk", "loads of g", "items' own work")
    print(f"K4 at B=8 x 128, P=7, 38x64x512 bf16, plan cc={cc} band_rows={rows}: "
          + ", ".join(f"{k} {ms[k]:.4f} ms" for k in names))
    for part, hi, lo in zip(parts, names, names[1:]):
        print(f"  {part}: {ms[hi] - ms[lo]:.4f} ms ({(ms[hi] - ms[lo]) / ms[names[0]] * 100:.1f}%)")
    print(f"  frame: {ms[names[-1]]:.4f} ms ({ms[names[-1]] / ms[names[0]] * 100:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
