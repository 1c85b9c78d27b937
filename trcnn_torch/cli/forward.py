"""One image -> detections, drawn onto a copy of the image: the port's
counterpart of ``scripts/forward.py`` (the reference's ``forward.py``).

    python -m trcnn_torch.cli.forward --img_fn img.jpg --out_fn result.jpg \
        --pretrained_model weights.npz

The image is decoded, and the boxes drawn, with cv2 or else PIL
(``trcnn_torch.data.image``); without either it stops, naming both.  Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from trcnn_torch.cli import DTYPES, add_common_flags, make_config, setup_device
from trcnn_torch.config import VOC_CLASSES
from trcnn_torch.data.image import read_image, write_detections
from trcnn_torch.data.loader import upload
from trcnn_torch.data.preprocess import preprocess_image
from trcnn_torch.models.faster_rcnn import cast_params_for_inference, make_model, postprocess
from trcnn_torch.weights import import_weights


def load_model(cfg, dtype: torch.dtype, device: torch.device, pretrained: Optional[str] = None,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0):
    """The model for inference on ``device``: ``state_dict``, or the
    weights of ``pretrained`` (every tensor must be there), else the seeded
    random init; cast once to ``dtype``; eval mode."""
    model = make_model(cfg, dtype=dtype, device=device)
    if state_dict is None and pretrained:
        state_dict = import_weights(pretrained, cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        print("[warn] no --pretrained_model: random init (smoke-test mode)", file=sys.stderr)
        model.init(torch.Generator(device=device).manual_seed(seed))
    return cast_params_for_inference(model, dtype).eval()


def format_detections(dets, i: int = 0) -> list:
    """Image i's detections, one line each: class, score, box."""
    boxes, scores, classes, valid = (t[i].cpu().numpy() for t in dets)
    return [f"  {VOC_CLASSES[classes[k]]:>12s} {scores[k]:.3f}  "
            f"({boxes[k, 0]:.1f}, {boxes[k, 1]:.1f}, {boxes[k, 2]:.1f}, {boxes[k, 3]:.1f})"
            for k in np.where(valid)[0]]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--img_fn", required=True, help="input image file")
    ap.add_argument("--out_fn", default="result.jpg", help="output image file")
    ap.add_argument("--score_thresh", type=float, default=None,
                    help="score threshold of the drawn detections (default 0.7)")
    ap.add_argument("--nms_thresh", type=float, default=None)
    ap.add_argument("--min_size", type=int, default=600)
    ap.add_argument("--max_size", type=int, default=1000)
    add_common_flags(ap)
    args = ap.parse_args(argv)

    dtype = DTYPES[args.dtype]
    device = setup_device(args.device, dtype)
    cfg = make_config(args.backbone)
    if (args.min_size, args.max_size) != (600, 1000):
        # the scale target only: the canvas (and its shape) stays the config's
        cfg = cfg.replace(image=dataclasses.replace(
            cfg.image, target_min_size=args.min_size, target_max_size=args.max_size))
    if args.nms_thresh is not None:
        cfg = cfg.replace(test=dataclasses.replace(cfg.test, nms_thresh=args.nms_thresh))
    score_thresh = (args.score_thresh if args.score_thresh is not None
                    else cfg.test.score_thresh_demo)

    img = read_image(args.img_fn)
    canvas, im_info = preprocess_image(img, cfg.image)
    images, info = upload(canvas[None], device), upload(im_info[None], device)
    model = load_model(cfg, dtype, device, args.pretrained_model)

    def run():
        with torch.inference_mode():
            dets = postprocess(model.detect(images, info), info, cfg, score_thresh=score_thresh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return dets

    t0 = time.perf_counter()
    run()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    dets = run()
    t_steady = time.perf_counter() - t0
    print(f"inference: {t_steady * 1e3:.1f} ms/img (first call incl. warm-up {t_first:.1f} s)")
    lines = format_detections(dets)
    print(f"{len(lines)} detections (score >= {score_thresh}):")
    print("\n".join(lines))
    boxes, scores, classes, valid = (t[0].cpu().numpy() for t in dets)
    write_detections(img, boxes[valid], [f"{VOC_CLASSES[c]} {s:.2f}" for c, s in
                                         zip(classes[valid], scores[valid])], args.out_fn)
    print(f"wrote {args.out_fn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
