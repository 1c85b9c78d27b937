"""One-command accuracy-parity harness, the port's counterpart of
``scripts/parity.py`` (the release gate: VOC07 mAP within 0.5 pt of the
reference's 69.9).

    python -m trcnn_torch.cli.parity --voc_root /path/VOCdevkit/VOC2007 \
        --reference_npz VGG16_faster_rcnn_final.npz

It performs, in order:

1. the weight import through the port's importer
   (``trcnn_torch.convert_chainer.import_chainer_npz``: OIHW, the fc6
   permutation, the bbox_pred normalization);
2. per-box goldens on the first ``--golden_images`` test images, detected
   one at a time: the boxes (rounded to 4 decimals), scores (6 decimals)
   and classes go to ``--golden`` (JSON) if it does not exist, or are
   compared with it if it does, with the largest deltas reported; the
   file's format is the JAX script's, so a golden written by either
   package is read by the other;
3. the full evaluation through the port's ``Evaluator`` (VOC07 11-point
   mAP and the per-class table);
4. the verdict: ``PARITY PASS`` iff mAP >= ``--target_map`` - 0.005, exit
   0 on pass and 2 on fail.

``--dataset synthetic`` is the harness's smoke mode: the tiny config
(``trcnn_torch.entry.tiny_config``) on 32 small synthetic images, never
gated.  Without ``--reference_npz`` the model is the port's seeded init
(``FasterRCNN.init`` from seed 0), which stands in for the JAX script's
``model.init(PRNGKey(0))``: other numbers, the same role.  The detector
runs in float32 with TF32 off, on the card unless ``--device cpu`` (or
``--cpu``, its JAX-script spelling).  The default ``--golden`` is
``parity_goldens.json`` in the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from trcnn_torch.cli import make_config, setup_device
from trcnn_torch.convert_chainer import import_chainer_npz
from trcnn_torch.data import SyntheticDetection, VOCDetection
from trcnn_torch.entry import tiny_config
from trcnn_torch.eval import Evaluator
from trcnn_torch.models import make_model


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--voc_root", default=None, help="VOCdevkit/VOC2007 root (test split)")
    ap.add_argument("--reference_npz", default=None,
                    help="reference detector weights (chainer npz)")
    ap.add_argument("--split", default="test")
    ap.add_argument("--dataset", default="voc", choices=["voc", "synthetic"],
                    help="synthetic = harness smoke mode (no VOC needed)")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--limit", type=int, default=None,
                    help="cap evaluated images (full test split otherwise)")
    ap.add_argument("--golden", default="parity_goldens.json",
                    help="golden per-box outputs: written if absent, compared against if present")
    ap.add_argument("--golden_images", type=int, default=8,
                    help="images captured into the golden file")
    ap.add_argument("--target_map", type=float, default=0.699,
                    help="reference mAP to be within 0.5 pt of")
    ap.add_argument("--tolerance_box", type=float, default=0.1,
                    help="max per-coordinate golden delta (pixels)")
    ap.add_argument("--tolerance_score", type=float, default=1e-3)
    ap.add_argument("--out", default=None, help="write the full parity report JSON here")
    ap.add_argument("--device", default="cuda", help="torch device: the card (default) or 'cpu'")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.dataset == "voc" and not args.voc_root:
        ap.error("--dataset voc requires --voc_root")
    return args


def golden_record(detections) -> Dict[str, dict]:
    """{id: {"boxes", "scores", "classes"}} as the golden file holds them:
    float64 boxes rounded to 4 decimals, scores to 6."""
    return {d["id"]: {"boxes": np.round(np.asarray(d["boxes"], np.float64), 4).tolist(),
                      "scores": np.round(np.asarray(d["scores"], np.float64), 6).tolist(),
                      "classes": np.asarray(d["classes"], int).tolist()}
            for d in detections}


def compare_golden(golden: Dict[str, dict], current: Dict[str, dict], tolerance_box: float,
                   tolerance_score: float) -> dict:
    """The largest box and score deltas over the golden images, the images
    whose detection set changed or is missing, and whether all is within
    the tolerances."""
    max_box, max_score, mismatches = 0.0, 0.0, []
    for iid, g in golden.items():
        c = current.get(iid)
        if c is None:
            mismatches.append(f"{iid}: missing")
            continue
        gb, cb = np.asarray(g["boxes"]), np.asarray(c["boxes"])
        gs, cs = np.asarray(g["scores"]), np.asarray(c["scores"])
        if gb.shape != cb.shape or g["classes"] != c["classes"]:
            mismatches.append(f"{iid}: detection set changed "
                              f"({gb.shape[0]} vs {cb.shape[0]} boxes)")
            continue
        if len(gb):
            max_box = max(max_box, float(np.abs(gb - cb).max()))
            max_score = max(max_score, float(np.abs(gs - cs).max()))
    ok = not mismatches and max_box <= tolerance_box and max_score <= tolerance_score
    return {"compared": len(golden), "max_box_delta": max_box, "max_score_delta": max_score,
            "mismatches": mismatches, "ok": ok}


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """The harness's four steps; returns the report (with "exit": the
    process's exit code)."""
    args = parse(argv)
    device = setup_device(args.device, torch.float32)
    if args.dataset == "voc":
        cfg = make_config("vgg16", "voc")
        ds = VOCDetection(args.voc_root, args.split, use_difficult=True)
    else:
        # smoke mode: the tiny model on tiny canvases, so that the harness's
        # plumbing runs in seconds (the real gate needs VOC anyway)
        cfg = tiny_config()
        ds = SyntheticDetection(n=32, num_classes=cfg.num_classes, seed=11,
                                hw_range=((48, 60), (64, 90)))
    model = make_model(cfg, device=device)
    report = {"weights": args.reference_npz, "dataset": args.dataset,
              "n_images": args.limit or len(ds)}

    # ---- 1. weight import
    if args.reference_npz:
        model.load_state_dict(import_chainer_npz(args.reference_npz, cfg))
        print(f"[parity] imported reference weights: {args.reference_npz}")
    else:
        print("[parity] WARNING: no --reference_npz — the port's seeded init "
              "(harness smoke only)", file=sys.stderr)
        model.init(torch.Generator(device=device).manual_seed(0))
    model.eval()
    evaluator = Evaluator(model, cfg, ds, batch_size=args.batch_size, limit=args.limit,
                          device=device)

    # ---- 2. per-box golden capture / comparison
    golden_eval = Evaluator(model, cfg, ds, batch_size=1, limit=args.golden_images,
                            device=device)
    current = golden_record(golden_eval.collect_detections())
    if os.path.exists(args.golden):
        with open(args.golden) as f:
            golden = json.load(f)
        report["golden"] = g = compare_golden(golden, current, args.tolerance_box,
                                              args.tolerance_score)
        print(f"[parity] golden check: {len(golden)} images, "
              f"max box Δ {g['max_box_delta']:.4g}px, max score Δ {g['max_score_delta']:.4g}, "
              f"{len(g['mismatches'])} mismatches → {'OK' if g['ok'] else 'FAIL'}")
    else:
        with open(args.golden, "w") as f:
            json.dump(current, f, indent=1)
        report["golden"] = {"captured": len(current), "path": args.golden}
        print(f"[parity] captured {len(current)}-image goldens → {args.golden}")

    # ---- 3. full mAP
    t0 = time.time()
    results = evaluator()
    map_v = results["eval_mAP"]
    for k in sorted(results):
        if k.startswith("eval_AP/"):
            print(f"  AP[{k.split('/', 1)[1]:>12s}] = {results[k]:.4f}")
    print(f"mAP = {map_v:.4f}  ({results['eval_images']:.0f} images, "
          f"{time.time() - t0:.1f}s)")
    report["mAP"] = map_v
    report["per_class"] = {k.split("/", 1)[1]: v for k, v in results.items()
                           if k.startswith("eval_AP/")}

    # ---- 4. verdict
    gate = args.target_map - 0.005
    passed = map_v >= gate
    if args.dataset == "synthetic":
        # smoke mode: a gate means nothing on random weights; report only
        passed = True
        print(f"[parity] smoke mode: harness ran end-to-end (mAP {map_v:.4f} not gated)")
    else:
        print(f"PARITY {'PASS' if passed else 'FAIL'}: mAP {map_v:.4f} vs "
              f"gate {gate:.4f} (reference {args.target_map:.4f} − 0.5 pt)")
    report["pass"] = bool(passed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return dict(report, exit=0 if passed else 2)


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run(argv)["exit"]


if __name__ == "__main__":
    sys.exit(main())
