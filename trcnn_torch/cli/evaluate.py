"""Detection evaluation: batched inference over a dataset and the VOC07
11-point mAP (or the VOC2010+ area), or COCO's AP@[.5:.95], the port's
counterpart of ``scripts/evaluate.py``.

    python -m trcnn_torch.cli.evaluate --dataset_root /path/VOC2007 --split test \
        --pretrained_model weights.npz --batch_size 8 --write_dets dets/
    python -m trcnn_torch.cli.evaluate --dataset coco --dataset_root /path/val2017 \
        --ann_file /path/instances_val2017.json --pretrained_model weights.npz

The config follows the dataset (COCO: 81 classes, the 800 x 1344 canvas,
1000 proposals), and so does the metric unless ``--metric`` names one.
``--checkpoint_dir`` reads the newest ``ckpt_<step>.pt`` that the port's
trainer (``python -m trcnn_torch.cli.train``) wrote.  ``--dataset
synthetic`` evaluates the built-in synthetic set.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from trcnn_torch.cli import DTYPES, add_common_flags, make_config, setup_device
from trcnn_torch.cli.forward import load_model
from trcnn_torch.config import VOC_CLASSES
from trcnn_torch.data import COCODetection, SyntheticDetection, VOCDetection
from trcnn_torch.eval import Evaluator
from trcnn_torch.eval.voc_ap import write_voc_detection_files
from trcnn_torch.train.trainer import latest_checkpoint


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="voc", choices=["voc", "coco", "synthetic"])
    ap.add_argument("--dataset_root", default=None,
                    help="VOCdevkit/VOC2007 root, or COCO image dir")
    ap.add_argument("--ann_file", default=None,
                    help="COCO instances json (with --dataset coco)")
    ap.add_argument("--metric", default=None, choices=["voc07", "voc", "coco"],
                    help="AP protocol: VOC2007 11-point, VOC2010+ area or COCO "
                         "AP@[.5:.95] (default: matches the dataset)")
    ap.add_argument("--split", default="test")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="directory of the port trainer's ckpt_<step>.pt; the newest is read")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--limit", type=int, default=None, help="evaluate the first N images only")
    ap.add_argument("--write_dets", default=None, metavar="DIR",
                    help="also write the VOC devkit's comp4_det_<split>_<class>.txt files")
    add_common_flags(ap)
    args = ap.parse_args(argv)
    if args.dataset == "coco" and not (args.dataset_root and args.ann_file):
        ap.error("--dataset coco requires --dataset_root and --ann_file")
    if args.dataset == "voc" and not args.dataset_root:
        ap.error("--dataset voc requires --dataset_root")
    return args


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI's work; returns {"metrics" (the evaluator's dict), "mAP" and
    "aps" (VOC metrics; None and {} with --metric coco), "images",
    "seconds" (of the detection pass), "timing" (the evaluator's), "files",
    "detections", "model", "checkpoint_step" (None without
    --checkpoint_dir)}."""
    args = parse(argv)
    dtype = DTYPES[args.dtype]
    device = setup_device(args.device, dtype)
    cfg = make_config(args.backbone, "coco" if args.dataset == "coco" else "voc")
    class_names = VOC_CLASSES
    if args.dataset == "voc":
        ds = VOCDetection(args.dataset_root, args.split, use_difficult=True)
    elif args.dataset == "coco":
        ds = COCODetection(args.dataset_root, args.ann_file, use_crowd=True)
        class_names = ds.class_names
    else:
        ds = SyntheticDetection(n=64, num_classes=cfg.num_classes)
    metric = args.metric or ("coco" if args.dataset == "coco" else "voc07")

    step = None
    if args.checkpoint_dir:
        step, path = latest_checkpoint(args.checkpoint_dir)
        model = load_model(cfg, dtype, device,
                           state_dict=torch.load(path, map_location=device)["model"])
        print(f"restored step {step} from {path}")
    else:
        model = load_model(cfg, dtype, device, args.pretrained_model)

    evaluator = Evaluator(model, cfg, ds, class_names=class_names, batch_size=args.batch_size,
                          limit=args.limit, metric=metric, device=device)
    out = evaluator()
    detections, seconds = evaluator.detections, evaluator.timing["wall_s"]
    n_img = len(detections)
    files = []
    if args.write_dets:
        files = write_voc_detection_files(class_names, detections, args.write_dets,
                                          split=args.split)
        print(f"wrote {len(files)} devkit detection files to {args.write_dets}")
    rate = f"({n_img} images, {n_img / max(seconds, 1e-9):.1f} img/s incl. warm-up)"
    mean_ap = out.get("eval_mAP")
    aps = {k[len("eval_AP/"):]: v for k, v in out.items() if k.startswith("eval_AP/")}
    if metric == "coco":
        print(f"AP={out['eval_AP']:.4f} AP50={out['eval_AP50']:.4f} "
              f"AP75={out['eval_AP75']:.4f}  {rate}")
    else:
        for name, v in sorted(aps.items()):
            print(f"  AP[{name:>12s}] = {v:.4f}")
        print(f"mAP = {mean_ap:.4f}  {rate}")
    return {"metrics": out, "mAP": mean_ap, "aps": aps, "images": n_img, "seconds": seconds,
            "timing": evaluator.timing, "files": files, "detections": detections,
            "model": model, "checkpoint_step": step}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
