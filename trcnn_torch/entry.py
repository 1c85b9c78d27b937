"""Entry point: the full image -> detections graph on one device
(counterpart of ``__graft_entry__.entry``).

``entry(device)`` builds the VGG-16 VOC model (608x1024 canvas, im_info
(600, 1000, 1.6)) with random weights, casts it for bf16 inference, and
returns ``(fn, (model, images, im_info))`` with one uint8 canvas; weights
and canvas are made from seed 0.  ``fn(model, images, im_info)`` runs
detect + postprocess.  Tests pass a small config
(``__graft_entry__._tiny_cfg`` style) to run the same graph on the CPU; its
im_info is the canvas minus 4 pixels at unit scale.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from trcnn_torch.config import FasterRCNNConfig, voc_config
from trcnn_torch.models.faster_rcnn import (Detections, cast_params_for_inference,
                                            make_model, postprocess)


def entry(device, cfg: Optional[FasterRCNNConfig] = None,
          dtype: torch.dtype = torch.bfloat16
          ) -> Tuple[Callable[..., Detections], tuple]:
    device = torch.device(device)
    if cfg is None:
        cfg = voc_config()
        im_info_row = (600.0, 1000.0, 1.6)
    else:
        im_info_row = (float(cfg.image.pad_h - 4), float(cfg.image.pad_w - 4), 1.0)
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(cfg, dtype=dtype, device=device).init(gen)
    cast_params_for_inference(model, dtype).eval()
    images = torch.randint(0, 256, (1, cfg.image.pad_h, cfg.image.pad_w, 3),
                           dtype=torch.uint8, generator=gen, device=device)
    im_info = torch.tensor([im_info_row], dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(m, x, info) -> Detections:
        return postprocess(m.detect(x, info), info, cfg)

    return fn, (model, images, im_info)
