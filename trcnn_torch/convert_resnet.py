"""ResNet-101 pretrained-weight import: the port's own copy of
``trcnn/convert/resnet_npz.py`` (numpy only; no JAX, no ``trcnn``).

Two source naming schemes:

* **torchvision**: ``conv1.weight``, ``bn1.{weight,bias,running_mean,
  running_var}``, ``layerL.B.convN.weight``, ``layerL.B.downsample.{0,1}``
  (an npz of a PyTorch ``state_dict``);
* **chainercv**: ``res2/a/conv1/W``, ``res2/a/bn1/{gamma,beta,avg_mean,
  avg_var}``, blocks named a, b1, b2, ..., the projection ``conv4``/``bn4``.

Stages ``layer1..3`` / ``res2..4`` go to the C4 trunk (``extractor.res2..4``),
``layer4`` / ``res5`` to the C5 RoI head (``head.res5``); projections map to
``proj`` / ``proj_bn``.  RPN convolutions and the head's ``cls_score`` /
``bbox_pred``, when the npz holds them (chainer naming, found by key
suffix), import too.

With ``fold_preprocess`` (the default for torchvision sources) conv1 is
rewritten to take this pipeline's input, BGR 0-255 minus the Caffe pixel
means, instead of torchvision's RGB [0, 1] normalised by the ImageNet mean
and std:

    kernel'[:, :, c, :] = kernel[:, :, rgb(c), :] / (255 * std_rgb(c))
    bn1.mean'_o += sum_{k, c} kernel'[k, c, o] * (255 * mean_c - pixel_mean_c)

exact away from the 3-pixel zero-padded border.

The tensors are assembled in the JAX package's flax layout (HWIO kernels),
with its arithmetic and its order, then mapped by
``trcnn_torch.convert.flax_to_state_dict``: the result is the port's
``state_dict`` entries, tensor for tensor what the JAX importer followed by
that bridge gives.  An ImageNet trunk leaves the RPN and the output
layers out: load it with ``model.load_state_dict(sd, strict=False)`` over
a seeded init.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.convert import flax_to_state_dict

# ImageNet normalisation of torchvision's pretrained models (RGB)
TV_MEAN_RGB = (0.485, 0.456, 0.406)
TV_STD_RGB = (0.229, 0.224, 0.225)

_STAGE_BLOCKS = {"res2": 3, "res3": 4, "res4": 23, "res5": 3}


def _chainer_block(i: int) -> str:
    return "a" if i == 0 else f"b{i}"


def _conv_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(2, 3, 1, 0))


def _find(npz: Dict[str, np.ndarray], suffix: str, leaf: str) -> Optional[np.ndarray]:
    """``.../<suffix>/<leaf>`` in a flat npz key space."""
    want = f"{suffix}/{leaf}"
    for k in npz.keys():
        if k == want or k.endswith("/" + want):
            return npz[k]
    return None


def _with_bias(kernel: np.ndarray, b: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    return {"kernel": kernel} if b is None else {"kernel": kernel, "bias": b}


def detect_source(npz: Dict[str, np.ndarray]) -> str:
    keys = npz.keys()
    if any(k.startswith("layer1.") or k == "conv1.weight" for k in keys):
        return "torchvision"
    if any("res2/a/" in k or k.startswith("res2/") for k in keys):
        return "chainercv"
    raise KeyError("unrecognized ResNet npz naming (expected torchvision "
                   "'layer1.0.conv1.weight' or chainercv 'res2/a/conv1/W' keys)")


def _bn(npz, prefix: str, source: str) -> Dict[str, np.ndarray]:
    names = (("weight", "bias", "running_mean", "running_var") if source == "torchvision"
             else ("gamma", "beta", "avg_mean", "avg_var"))
    sep = "." if source == "torchvision" else "/"
    return {leaf: np.asarray(npz[f"{prefix}{sep}{name}"], np.float32)
            for leaf, name in zip(("scale", "bias", "mean", "var"), names)}


def _fold_conv1(kernel_hwio: np.ndarray, bn1: Dict[str, np.ndarray], pixel_means_bgr) -> None:
    """In place: conv1 (7, 7, 3, 64), input channels in RGB order, and bn1's
    mean rewritten for BGR 0-255 minus the pixel means (module docstring)."""
    k = kernel_hwio
    k[:] = k[:, :, ::-1, :]
    std_bgr = np.asarray(TV_STD_RGB[::-1], np.float32)
    mean_bgr = np.asarray(TV_MEAN_RGB[::-1], np.float32)
    k /= (255.0 * std_bgr)[None, None, :, None]
    # the constant input offset d_c = 255 mean_c - pixel_mean_c lands in
    # bn1's mean (BN subtracts the mean, so the conv's response is added)
    d = 255.0 * mean_bgr - np.asarray(pixel_means_bgr, np.float32)
    bn1["mean"] = bn1["mean"] + np.einsum("hwco,c->o", k, d)


def import_resnet101_npz(path_or_dict,
                         cfg: FasterRCNNConfig = FasterRCNNConfig(backbone="resnet101"),
                         source: str = "auto", fold_preprocess: Optional[bool] = None,
                         strict: bool = True) -> Dict[str, torch.Tensor]:
    """A ResNet-101 npz (path or {key: array}) -> the port's state_dict
    entries for the R101 Faster R-CNN (a partial one for an ImageNet trunk).

    source: 'torchvision' | 'chainercv' | 'auto' (from the key names).
    fold_preprocess: rewrite conv1 / bn1 for this pipeline's input; the
    default is True for torchvision and False for chainercv (already BGR
    0-255).  strict: raise on any missing backbone tensor.
    """
    if isinstance(path_or_dict, (str, bytes)):
        npz = dict(np.load(path_or_dict, allow_pickle=False))
    else:
        npz = dict(path_or_dict)
    if source == "auto":
        source = detect_source(npz)
    if fold_preprocess is None:
        fold_preprocess = source == "torchvision"
    tv = source == "torchvision"

    missing = []
    extractor: Dict = {}
    head: Dict = {}

    def take(fn):
        try:
            return fn()
        except KeyError as e:
            missing.append(str(e))
            return None

    w = take(lambda: _conv_hwio(npz["conv1.weight" if tv else "conv1/W"]))
    bn1 = take(lambda: _bn(npz, "bn1", source))
    if w is not None and bn1 is not None:
        if fold_preprocess:
            _fold_conv1(w, bn1, cfg.image.pixel_means_bgr)
        extractor["conv1"] = {"kernel": w}
        extractor["bn1"] = bn1

    for si, stage in enumerate(("res2", "res3", "res4", "res5")):
        blocks: Dict = {}
        for bi in range(_STAGE_BLOCKS[stage]):
            blk: Dict = {}
            p = f"layer{si + 1}.{bi}" if tv else f"{stage}/{_chainer_block(bi)}"
            for ci in (1, 2, 3):
                kw = take(lambda c=ci: _conv_hwio(
                    npz[f"{p}.conv{c}.weight" if tv else f"{p}/conv{c}/W"]))
                bb = take(lambda c=ci: _bn(npz, f"{p}.bn{c}" if tv else f"{p}/bn{c}", source))
                if kw is not None:
                    blk[f"conv{ci}"] = {"kernel": kw}
                if bb is not None:
                    blk[f"bn{ci}"] = bb
            proj = f"{p}.downsample.0.weight" if tv else f"{p}/conv4/W"
            if proj in npz:
                blk["proj"] = {"kernel": _conv_hwio(npz[proj])}
                blk["proj_bn"] = _bn(npz, f"{p}.downsample.1" if tv else f"{p}/bn4", source)
            elif bi == 0:
                missing.append(proj)
            if blk:
                blocks[f"block{bi + 1}"] = blk
        if blocks:
            (head if stage == "res5" else extractor)[stage] = blocks

    # full-detector extras, chainer-npz style (found by key suffix)
    rpn: Dict = {}
    for name, suffixes in (("rpn_conv", ("rpn_conv_3x3", "rpn_conv")),
                           ("rpn_cls_score", ("rpn_cls_score",)),
                           ("rpn_bbox_pred", ("rpn_bbox_pred",))):
        for sfx in suffixes:
            wr = _find(npz, sfx, "W")
            if wr is not None:
                rpn[name] = _with_bias(np.ascontiguousarray(wr.transpose(2, 3, 1, 0)),
                                       _find(npz, sfx, "b"))
                break
    for name in ("cls_score", "bbox_pred"):
        wl = _find(npz, name, "W")
        if wl is not None:
            head[name] = _with_bias(np.ascontiguousarray(wl.T), _find(npz, name, "b"))

    if strict and missing:
        raise KeyError(f"missing tensors in ResNet-101 npz: {missing}")
    params = {k: v for k, v in (("extractor", extractor), ("rpn", rpn), ("head", head)) if v}
    return flax_to_state_dict(params)
