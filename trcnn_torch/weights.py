"""Pretrained-weight import by format and backbone: the port's copy of
``trcnn/convert/__init__.py:import_weights``.

- a ``.caffemodel`` file goes through the wire parser
  (:mod:`trcnn_torch.convert_caffemodel`);
- for ``cfg.backbone == "resnet101"``, a torchvision or chainercv npz
  through :mod:`trcnn_torch.convert_resnet`;
- otherwise a Chainer VGG-16 npz through :mod:`trcnn_torch.convert_chainer`.

Each returns the port's state_dict entries (a partial one with
``strict=False``: overlay it with ``convert_chainer.merge_params``).
"""

from __future__ import annotations

from typing import Dict

import torch

from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.convert_caffemodel import import_caffemodel
from trcnn_torch.convert_chainer import import_chainer_npz
from trcnn_torch.convert_resnet import import_resnet101_npz


def import_weights(path_or_dict, cfg: FasterRCNNConfig, strict: bool = True
                   ) -> Dict[str, torch.Tensor]:
    if isinstance(path_or_dict, str) and path_or_dict.endswith(".caffemodel"):
        return import_caffemodel(path_or_dict, cfg, strict=strict)
    if cfg.backbone == "resnet101":
        return import_resnet101_npz(path_or_dict, cfg, strict=strict)
    return import_chainer_npz(path_or_dict, cfg, strict=strict)
