"""Command-line entry points of the port, each ``python -m
trcnn_torch.cli.<name>`` and ``main(argv=None)``: ``forward`` (one image ->
detections), ``evaluate`` (a dataset -> VOC mAP and devkit files, or COCO
AP), ``train``, ``parity`` (the accuracy gate), and ``convert`` and
``download`` (weights, numpy on the host).  Those that run the model run
on the card unless given ``--device cpu``.

Shared here: the flags every one of them has, and the device set-up.  In
float32 (the default, bit-parity with the reference) TF32 is off for
cuDNN and matmul; in bfloat16 the inference CLIs cast the weights once
(``cast_params_for_inference``), as ``trcnn_torch.entry`` does.
"""

from __future__ import annotations

import argparse

import torch

from trcnn_torch.config import FasterRCNNConfig, coco_config, voc_config

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_common_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--pretrained_model", default=None,
                    help="weights: a Chainer-format VGG-16 npz, a torchvision or chainercv "
                         "ResNet-101 npz (with --backbone resnet101), or a .caffemodel")
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES),
                    help="compute dtype; float32 = bit-parity with the reference (TF32 off)")
    ap.add_argument("--backbone", default="vgg16", choices=["vgg16", "resnet101"])
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card (default) or 'cpu'")


PRESETS = {"voc": voc_config, "coco": coco_config}


def make_config(backbone: str, preset: str = "voc") -> FasterRCNNConfig:
    """The VOC or COCO config (``preset``) with ``backbone``."""
    return PRESETS[preset]().replace(backbone=backbone)


def setup_device(name: str, dtype: torch.dtype) -> torch.device:
    """The device; in float32 on the card, TF32 off (the reference's
    arithmetic)."""
    device = torch.device(name)
    if device.type == "cuda" and dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
