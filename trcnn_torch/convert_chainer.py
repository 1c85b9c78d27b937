"""Chainer ``.npz`` <-> the port's ``state_dict``: the port's own copy of
``trcnn/convert/chainer_npz.py`` (numpy only; no JAX, no ``trcnn``).

The reference loads ``VGG16_faster_rcnn_final`` with
``serializers.load_npz``: a flat npz keyed by link path, with Chainer's
layouts (Convolution2D ``W`` is OIHW, Linear ``W`` is (out, in)).  The
import applies the reference's three fix-ups, in the JAX package's order
and arithmetic:

1. conv kernels OIHW -> HWIO (then the bridge's HWIO -> OIHW, a pure
   relayout);
2. fc6's (4096, 25088) kernel from Chainer's NCHW flatten order
   (c*49 + h*7 + w) to the NHWC order (h*7*512 + w*512 + c) that the
   port's fc6 also reads;
3. bbox_pred from the reference's unnormalised test-time convention to the
   normalised deltas every head here emits:
       W'' = W / std_per_output,   b'' = (b - mean_per_output) / std
   in float64, rounded once to float32.

Keys resolve by suffix, so ``trunk/conv1_1/W`` and ``vgg/conv1_1/W`` trees
import alike.  The tensors are assembled in the flax layout and mapped by
``trcnn_torch.convert.flax_to_state_dict``: the result is, tensor for
tensor, what the JAX importer followed by that bridge gives.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from trcnn_torch.config import FasterRCNNConfig
from trcnn_torch.convert import flax_to_state_dict, state_dict_to_flax
from trcnn_torch.models.vgg16 import VGG_CFG

# (flax module path under params/, chainer key suffix)
_VGG_CONVS = [(("extractor", f"{name}_{i + 1}"), f"{name}_{i + 1}")
              for name, n, _ in VGG_CFG for i in range(n)]
_RPN_CONVS = [(("rpn", "rpn_conv"), "rpn_conv_3x3"),
              (("rpn", "rpn_conv"), "rpn_conv"),
              (("rpn", "rpn_cls_score"), "rpn_cls_score"),
              (("rpn", "rpn_bbox_pred"), "rpn_bbox_pred")]
_LINEARS = [(("head", "fc6"), "fc6"), (("head", "fc7"), "fc7"),
            (("head", "cls_score"), "cls_score"), (("head", "bbox_pred"), "bbox_pred")]


def _find(npz: Mapping[str, np.ndarray], suffix: str, leaf: str) -> Optional[np.ndarray]:
    """``.../<suffix>/<leaf>`` in a flat npz key space."""
    want = f"{suffix}/{leaf}"
    for k in npz.keys():
        if k == want or k.endswith("/" + want):
            return npz[k]
    return None


def _load_npz(path_or_dict) -> Dict[str, np.ndarray]:
    """An npz path or an already-loaded {key: array} mapping -> a dict."""
    if isinstance(path_or_dict, (str, bytes)):
        with np.load(path_or_dict, allow_pickle=False) as f:
            return dict(f)
    return dict(path_or_dict)


def permute_fc6_kernel(w_chainer: np.ndarray, pool: int = 7, channels: int = 512) -> np.ndarray:
    """(4096, C*P*P in NCHW flatten order) -> (P*P*C in NHWC order, 4096)."""
    out_dim = w_chainer.shape[0]
    w = w_chainer.reshape(out_dim, channels, pool, pool)  # (O, C, H, W)
    w = w.transpose(2, 3, 1, 0)                           # (H, W, C, O)
    return w.reshape(pool * pool * channels, out_dim)


def _with_bias(kernel: np.ndarray, b: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    return {"kernel": kernel} if b is None else {"kernel": kernel, "bias": b}


def _bbox_stats(cfg: FasterRCNNConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output (std, mean) of the bbox_pred layer, float64."""
    pt = cfg.proposal_targets
    return (np.tile(np.asarray(pt.bbox_normalize_stds, np.float64), cfg.num_classes),
            np.tile(np.asarray(pt.bbox_normalize_means, np.float64), cfg.num_classes))


def import_chainer_npz(path_or_dict, cfg: FasterRCNNConfig = FasterRCNNConfig(),
                       normalize_bbox_pred: bool = True, strict: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """A Chainer Faster R-CNN npz (path or {key: array}) -> the port's
    VGG-16 state_dict entries.

    normalize_bbox_pred: fix-up 3 (True for the reference's final detection
    weights).  strict: raise if a tensor is missing; with strict=False the
    result holds only the layers the npz has (an ImageNet trunk: no RPN or
    head): overlay it on a model's state_dict with :func:`merge_params`.
    """
    npz = _load_npz(path_or_dict)
    params: Dict = {"extractor": {}, "rpn": {}, "head": {}}

    def put(dest: Tuple[str, str], value: Dict[str, np.ndarray]) -> None:
        params[dest[0]][dest[1]] = {k: np.asarray(v, np.float32) for k, v in value.items()}

    missing = []
    for dest, suffix in _VGG_CONVS:
        w = _find(npz, suffix, "W")
        if w is None:
            missing.append(suffix)
            continue
        put(dest, _with_bias(np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                             _find(npz, suffix, "b")))

    seen_rpn = set()
    for dest, suffix in _RPN_CONVS:
        if dest[1] in seen_rpn:
            continue
        w = _find(npz, suffix, "W")
        if w is None:
            continue
        seen_rpn.add(dest[1])
        put(dest, _with_bias(np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                             _find(npz, suffix, "b")))
    missing += [n for n in ("rpn_conv", "rpn_cls_score", "rpn_bbox_pred") if n not in seen_rpn]

    for dest, suffix in _LINEARS:
        w = _find(npz, suffix, "W")
        if w is None:
            missing.append(suffix)
            continue
        b = _find(npz, suffix, "b")
        kernel = permute_fc6_kernel(w) if suffix == "fc6" else np.ascontiguousarray(w.T)
        out = _with_bias(kernel, b)
        if suffix == "bbox_pred" and normalize_bbox_pred:
            stds, means = _bbox_stats(cfg)
            out["kernel"] = (out["kernel"].astype(np.float64) / stds[None, :]).astype(np.float32)
            if "bias" in out:
                out["bias"] = ((out["bias"].astype(np.float64) - means) / stds).astype(np.float32)
        put(dest, out)

    if strict and missing:
        raise KeyError(f"missing tensors in chainer npz: {missing}")
    return flax_to_state_dict({k: v for k, v in params.items() if v})


def merge_params(base: Mapping[str, torch.Tensor], overlay: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``base`` (a model's state_dict) with every entry of ``overlay`` (a
    partial import) in its place: the warm start, where the trunk (and
    fc6/fc7 when present) come from the file and the rest keeps its seeded
    init.  An overlay entry the model does not have, or of another shape,
    raises."""
    out = dict(base)
    for k, v in overlay.items():
        if k not in out:
            raise KeyError(f"{k} is not a parameter of the model")
        if tuple(v.shape) != tuple(out[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} does not match the model's "
                             f"{tuple(out[k].shape)}")
        out[k] = v
    return out


def export_chainer_npz(state_dict: Mapping[str, torch.Tensor], path: str,
                       cfg: FasterRCNNConfig = FasterRCNNConfig()) -> None:
    """The inverse mapping, a VGG-16 state_dict -> a Chainer npz, so trained
    weights go back to the reference's format; bbox_pred is un-normalised
    on the way out (the reference's final-weights convention).

    bbox_pred's W and b are written in float64, the JAX package's exporter
    rounds them to float32: multiplying by a std of 0.1 or 0.2 and rounding
    to float32 loses bits that dividing again cannot restore, so export ->
    import would not give the same weights back; in float64 it does, bit
    for bit, and their float32 rounding is what the JAX package writes (the
    reference's loader casts them into its float32 parameters).
    """
    p = state_dict_to_flax(state_dict)["params"]
    flat: Dict[str, np.ndarray] = {}

    def conv(key: str, sub: Dict[str, np.ndarray]) -> None:
        flat[f"{key}/W"] = np.asarray(sub["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in sub:
            flat[f"{key}/b"] = np.asarray(sub["bias"])

    for dest, suffix in _VGG_CONVS:
        conv(f"trunk/{suffix}", p[dest[0]][dest[1]])
    for name in ("rpn_conv", "rpn_cls_score", "rpn_bbox_pred"):
        conv(f"rpn/{'rpn_conv_3x3' if name == 'rpn_conv' else name}", p["rpn"][name])
    for name in ("fc6", "fc7", "cls_score", "bbox_pred"):
        sub = p["head"][name]
        w = np.asarray(sub["kernel"])
        b = np.asarray(sub["bias"]) if "bias" in sub else None
        if name == "fc6":
            hidden = w.shape[1]
            wc = w.reshape(7, 7, 512, hidden).transpose(3, 2, 0, 1).reshape(hidden, 7 * 7 * 512)
        else:
            wc = w.T
        if name == "bbox_pred":
            stds, means = _bbox_stats(cfg)
            wc = wc.astype(np.float64) * stds[:, None]
            if b is not None:
                b = b.astype(np.float64) * stds + means
        flat[f"{name}/W"] = wc if name == "bbox_pred" else wc.astype(np.float32)
        if b is not None:
            flat[f"{name}/b"] = b
    np.savez(path, **flat)
