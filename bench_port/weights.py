"""The benchmark's weights, made on the device from the seed.

Every weight of the configuration (:func:`bench_port.reference.nets.param_spec`)
comes from two draws of one generator on the card, a normal and a uniform
vector as long as all the weights together, cut into the leaves:

- convolutions and dense layers: fan-in scaled normal, cut at two sigma
  (flax's lecun_normal, the port's own init);
- biases: normal(0, 0.01), so that the bias paths carry numbers;
- the RPN's layers normal(0, 0.01), cls_score 0.01, bbox_pred 0.001;
- ResNet-101: every bottleneck's conv3 normal(0, 0.02) and every FrozenBN's
  scale uniform in [0.5, 1.5) and bias normal(0, 0.1), so that the
  residual branches are awake, as the repository's card checks make them
  (``chip_smoke.wake_residuals``).

Then :func:`calibrate`, with the benchmark's own float32 reference forward
on the first two images: for ResNet-101 it sets the stem's FrozenBN (bn1)
mean and variance to those of its input there, as a trained network's
are, so that the trunk runs at the scale of unit activations and not of
raw pixels (at that scale the recipe's learning rate diverges within
three steps); the residual blocks keep their random statistics (fitted
too, they make the random 33-block trunk chaotic: bf16 and float32
features 62% apart).  Then it spreads the RPN's and the head's outputs,
as ``chip_smoke.calibrate`` does, so that the proposal layer and the
epilogue keep detections.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_port.reference import nets

STD = {"bias": 0.01, "rpn": 0.01, "cls": 0.01, "bbox": 0.001, "conv3": 0.02,
       "bn_mean": 0.1, "bn_bias": 0.1}
# flax's truncated_normal(-2, 2) rescaled to unit variance
TRUNC_STD = 0.87962566103423978


def make(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights for ``spec`` from ``seed``, on ``device``."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        z, u = normal[off:off + n].view(shape), uniform[off:off + n].view(shape)
        off += n
        if kind in ("conv", "dense"):
            std = math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD
            out[name] = z.clamp(-2.0, 2.0) * std
        elif kind in ("bn_scale", "bn_var"):
            out[name] = u + 0.5
        else:
            out[name] = z * STD[kind]
    return out


@torch.no_grad()
def calibrate(w: Dict[str, torch.Tensor], cfg, images: torch.Tensor,
              im_info: torch.Tensor) -> None:
    """Fit ResNet-101's stem FrozenBN statistics on ``images``; scale
    rpn_cls_score to logits of std 2 and rpn_bbox_pred to deltas of std
    0.15, then cls_score to scores of std 2 and bbox_pred to deltas of std
    0.1 on eight fixed RoIs per image, in place."""
    net = nets.Net.for_config(w, cfg)
    rois = torch.stack([torch.tensor([10.0, 10.0, 80.0, 90.0]) + 3 * i for i in range(8)])
    rois = rois.to(images.device).expand(images.shape[0], 8, 4).contiguous()
    with nets.float32_exact():
        net.fit_bn = frozenset({"extractor.bn1"} if cfg.backbone == "resnet101" else ())
        feat = net.trunk(nets.prepare(images, im_info, cfg.image.pixel_means_bgr))
        net.fit_bn = frozenset()
        crops = nets.pool(net, feat, rois, cfg.roi.mode, cfg.roi.spatial_scale)
        _, logits, deltas = net.rpn(feat)
        w["rpn.rpn_cls_score.weight"] *= 2.0 / float(logits.std())
        w["rpn.rpn_bbox_pred.weight"] *= 0.15 / float(deltas.std())
        cs, bp = net.head(crops)
        w["head.cls_score.weight"] *= 2.0 / float(cs.std())
        w["head.bbox_pred.weight"] *= 0.1 / float(bp.std())
