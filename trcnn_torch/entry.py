"""Entry points on one device: the full image -> detections graph
(counterpart of ``__graft_entry__.entry``) and the training step
(counterpart of ``benchmarks/bench_train.py``).

``entry(device)`` builds the VOC model (608x1024 canvas, im_info (600,
1000, 1.6)) with random weights, casts it for bf16 inference, and returns
``(fn, (model, images, im_info))`` with one uint8 canvas; weights and
canvas are made from seed 0.  ``fn(model, images, im_info)`` runs detect +
postprocess.  ``backbone`` picks VGG-16 (the default) or "resnet101"
(``voc_config().replace(backbone=...)``), as the JAX scripts' ``--backbone``
switch does.  ``quant="int8"`` builds the dynamic int8 model
(``make_model(..., quant="int8")``) and, as ``bench.py`` does, leaves its
weights float32: they are quantized from the float32 parameters.  A
config whose ``roi.mode`` is "align" pools with RoIAlign.

``train_entry(device)`` builds the same model for training (float32 master
parameters, compute in ``dtype``) with its Caffe-order optimizer, and a
device-resident batch: uint8 canvases, two gt boxes per image.  It returns
``(step_fn, (state, batch))``; ``step_fn(state, batch)`` takes one step in
place and returns the metrics.

Both run on the card unless the caller asks for the CPU; without a card the
default raises.  Tests pass a small config (``__graft_entry__._tiny_cfg``
style) to run the same graphs on the CPU; its im_info is the canvas minus 4
pixels at unit scale.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from trcnn_torch.config import FasterRCNNConfig, voc_config
from trcnn_torch.models.faster_rcnn import (Detections, cast_params_for_inference,
                                            make_model, postprocess)
from trcnn_torch.train.step import TrainState, train_step


def _setup(device, cfg: Optional[FasterRCNNConfig], backbone: Optional[str]):
    """(device, config, im_info row): the VOC config with ``backbone``
    ("vgg16" when None), or ``cfg``, whose backbone ``backbone`` must then
    name if given."""
    device = torch.device(device)
    if cfg is None:
        return (device, voc_config().replace(backbone=backbone or "vgg16"),
                (600.0, 1000.0, 1.6))
    if backbone not in (None, cfg.backbone):
        raise ValueError(f"backbone {backbone!r} differs from the config's {cfg.backbone!r}")
    return device, cfg, (float(cfg.image.pad_h - 4), float(cfg.image.pad_w - 4), 1.0)


def entry(device="cuda", cfg: Optional[FasterRCNNConfig] = None,
          dtype: torch.dtype = torch.bfloat16, backbone: Optional[str] = None,
          quant: str = "none") -> Tuple[Callable[..., Detections], tuple]:
    device, cfg, im_info_row = _setup(device, cfg, backbone)
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(cfg, dtype=dtype, device=device, quant=quant).init(gen)
    if quant == "none":
        cast_params_for_inference(model, dtype)
    model.eval()
    images = torch.randint(0, 256, (1, cfg.image.pad_h, cfg.image.pad_w, 3),
                           dtype=torch.uint8, generator=gen, device=device)
    im_info = torch.tensor([im_info_row], dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(m, x, info) -> Detections:
        return postprocess(m.detect(x, info), info, cfg)

    return fn, (model, images, im_info)


# bench_train.py's gt: two boxes per image, classes 3 and 7, in canvas
# coordinates of the 600 x 1000 image
TRAIN_GT_BOXES = ((40.0, 60.0, 300.0, 280.0), (350.0, 100.0, 600.0, 420.0))
TRAIN_GT_LABELS = (3, 7)


def train_entry(device="cuda", cfg: Optional[FasterRCNNConfig] = None,
                dtype: torch.dtype = torch.bfloat16, batch_size: int = 8,
                backbone: Optional[str] = None
                ) -> Tuple[Callable[..., Dict[str, torch.Tensor]], tuple]:
    """The training step at the VOC config with ``backbone`` (or ``cfg``),
    weights and uint8 canvases from seed 0; the gt boxes are scaled into a
    small config's canvas."""
    device, cfg, im_info_row = _setup(device, cfg, backbone)
    gen = torch.Generator(device=device).manual_seed(0)
    model = make_model(cfg, dtype=dtype, device=device).init(gen)
    images = torch.randint(0, 256, (batch_size, cfg.image.pad_h, cfg.image.pad_w, 3),
                           dtype=torch.uint8, generator=gen, device=device)
    gt = torch.tensor(TRAIN_GT_BOXES, dtype=torch.float32)
    gt = gt * min(1.0, im_info_row[0] / 600.0, im_info_row[1] / 1000.0)
    batch = {
        "images": images,
        "im_info": torch.tensor([im_info_row], dtype=torch.float32).expand(batch_size, 3),
        "gt_boxes": gt.expand(batch_size, -1, -1),
        "gt_labels": torch.tensor(TRAIN_GT_LABELS, dtype=torch.int32).expand(batch_size, -1),
        "gt_valid": torch.ones((batch_size, len(TRAIN_GT_LABELS)), dtype=torch.bool),
    }
    batch = {k: v.contiguous().to(device) for k, v in batch.items()}
    return train_step, (TrainState.create(model), batch)
