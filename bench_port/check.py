"""The comparison that decides ``correct``: the numbers each cell compares
between what the port's timed path produced and the float32 reference,
and the judgement against the cell's limits (``limits/<cell>.json``).

Detect (one sampled call of the window, stage by stage; the reference works
each stage out again from the images and the benchmark's weights):

- ``feat``: the trunk's features, relative rms distance from the
  reference's (||port - ref|| / ||ref||);
- ``feat_channels``: the 90th percentile over channels of each channel's
  relative rms distance (:func:`channel_gap`);
- ``rpn``: the RPN's fg probabilities and deltas, the larger relative rms
  distance;
- ``proposals``: the proposal layer re-derived from the port's RPN outputs
  (a discrete stage is followed from the program's own input): slots whose
  validity differs or whose box is more than 1e-3 px away;
- ``crops``: the RoI crops the head took, of the valid RoIs of one image
  drawn from the seed (among its first CROP_ROWS), against the reference's
  pool of the port's own features at the port's RoIs: the largest
  difference over the largest reference value; a max pool rounds nothing,
  so it reads 0;
- ``head``: the head re-run in float32 on crops pooled from the port's
  features at the port's RoIs: the larger relative rms distance of the
  row-centred log class probabilities and of the deltas, over valid RoIs;
- ``chain``: the same with the reference's own features: the whole chain
  from the images, the RoIs taken from the port;
- ``detections``: the epilogue re-derived from the port's head outputs:
  detection slots whose validity, class or score differs, or whose box is
  more than 1e-3 px away.

Train (the first three steps of the state the window then drives):

- ``loss``: the largest relative gap of a step's total loss;
- ``grad``: the first gradient as the optimizer took it (worked out from
  its momentum after one step), by the worst leaf the update moves: the
  gap between the port's and the reference's norms over the larger of
  that leaf's reference norm and the median leaf's;
- ``grad_frozen``: the same over every leaf with a gradient, ResNet-101's
  frozen FrozenBN leaves included (their statistics' gradients come from
  a difference of two sums that nearly cancel);
- ``change``: the parameters' change over the three steps, by the worst
  leaf, alike;
- ``grad_median``, ``change_median``: the median leaf's gaps, steadier
  from seed to seed than the worst leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of ``grad`` and ``change``: they move by round-off.
"""

from __future__ import annotations

import json
import math
import statistics
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from bench_port.reference import boxes as rb
from bench_port.reference import nets
from bench_port.reference.nets import Net, is_frozen, prepare, runs_without_grad
from bench_port.reference.train import first_gradient

BOX_TOL = 1e-3
SMALL_LEAF = 1e-3
CROP_ROWS = 64
# numbers every run reads; a cell's limits name those it compares
READ_ONLY = frozenset({"feat", "feat_channels", "rpn", "proposals", "crops", "head", "chain",
                       "detections", "loss", "loss1", "grad", "grad_frozen", "change",
                       "grad_median", "change_median"})


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def channel_gap(a: torch.Tensor, b: torch.Tensor, q: float = 0.9) -> float:
    """The q-quantile over channels (last axis) of each channel's relative
    rms distance; channels whose reference is all but zero are left out.  A
    floating-point rounding is relative to each value, a per-tensor integer
    scale is not, so this separates the two more than the whole tensor's
    distance does."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    ref = b.square().mean(0).sqrt()
    live = ref > 1e-6 * ref.max()
    gap = (a - b).square().mean(0).sqrt()[live] / ref[live]
    return float(torch.quantile(gap, q))


def _centred_logp(logp: torch.Tensor) -> torch.Tensor:
    return logp - logp.mean(-1, keepdim=True)


def head_gap(cls_prob: torch.Tensor, bbox_pred: torch.Tensor, cls_score_ref: torch.Tensor,
             bbox_ref: torch.Tensor, valid: torch.Tensor) -> float:
    lp = _centred_logp(torch.log(cls_prob.reshape(-1, cls_prob.shape[-1]).float()
                                 .clamp(min=1e-30))[valid])
    lr = _centred_logp(torch.log_softmax(cls_score_ref[valid], -1))
    return max(rel_rms(lp, lr), rel_rms(bbox_pred.reshape(-1, bbox_pred.shape[-1])[valid],
                                        bbox_ref[valid]))


def box_slots_apart(rois_a, valid_a, rois_b, valid_b) -> int:
    """Slots whose validity differs, or valid in both with a box more than
    BOX_TOL apart."""
    far = np.abs(np.asarray(rois_a, np.float64) - np.asarray(rois_b, np.float64)).max(-1) > BOX_TOL
    return int(((valid_a != valid_b) | (valid_a & valid_b & far)).sum())


class DetectCapture:
    """What one call of the detect window produced: the trunk's features,
    the RPN's outputs and a copy of the crops of image ``image`` (read by
    hooks and kept on the device: a copy to the host would stall the window
    for as long as the copy takes), the head's outputs and RoIs
    (``RawDetections``), and the detections copied to the host."""

    def __init__(self, image: int = 0):
        self.feat = self.fg_probs = self.deltas = self.crops = self.raw = self.dets = None
        self.index = None
        self.image = image

    def crop_rows(self, n: int) -> slice:
        """The rows of the image's crops among the call's ``n``."""
        per = n // self.feat.shape[0]
        return slice(self.image * per, self.image * per + min(per, CROP_ROWS))

    def hooks(self, model) -> List:
        def on_feat(_m, _a, out):
            self.feat = out

        def on_rpn(_m, _a, out):
            self.fg_probs, self.deltas = out.fg_probs, out.deltas

        def on_crops(_m, args):
            self.crops = args[0][self.crop_rows(args[0].shape[0])].clone()

        return [model.extractor.register_forward_hook(on_feat),
                model.rpn.register_forward_hook(on_rpn),
                model.head.register_forward_pre_hook(on_crops)]


def detect_numbers(cap: DetectCapture, images: torch.Tensor, im_info: torch.Tensor,
                   w: Mapping[str, torch.Tensor], cfg) -> Dict[str, float]:
    """The detect numbers of one captured call against the reference over
    weights ``w`` (on the card)."""
    net = Net.for_config(dict(w), cfg)
    mode, scale = cfg.roi.mode, cfg.roi.spatial_scale
    dev = images.device
    raw = cap.raw
    port_feat, fg_p, deltas_p = (t.to(dev) for t in (cap.feat, cap.fg_probs, cap.deltas))
    out = {}
    with nets.float32_exact(), torch.inference_mode():
        feat = net.trunk(prepare(images, im_info, cfg.image.pixel_means_bgr))
        out["feat"] = rel_rms(port_feat, feat)
        out["feat_channels"] = channel_gap(port_feat, feat)
        fg, _, deltas = net.rpn(feat)
        out["rpn"] = max(rel_rms(fg_p, fg), rel_rms(deltas_p, deltas))
        del fg, deltas
        rois, valid = rb.proposals(fg_p, deltas_p, im_info, cfg, train=False)
        out["proposals"] = box_slots_apart(rois, valid, raw.rois.float().cpu().numpy(),
                                           raw.roi_valid.cpu().numpy())
        rv = raw.roi_valid.reshape(-1)
        for name, f in (("head", port_feat.float()), ("chain", feat)):
            crops = nets.pool(net, f, raw.rois.float(), mode, scale)
            if name == "head":
                rows = cap.crop_rows(crops.shape[0])
                live = rv[rows]
                ref = crops[rows][live]
                got = cap.crops.to(dev).float().reshape(crops[rows].shape)[live]
                out["crops"] = float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)) \
                    if ref.numel() else 0.0
            cs, bp = net.head_chunked(crops)
            del crops
            out[name] = head_gap(raw.cls_prob, raw.bbox_pred, cs, bp, rv)
            del cs, bp
        ref = rb.postprocess(raw.rois, raw.roi_valid, raw.cls_prob, raw.bbox_pred, im_info, cfg)
    got = [t.numpy() for t in cap.dets]
    far = np.abs(ref[0].astype(np.float64) - got[0]).max(-1) > BOX_TOL
    apart = (ref[3] != got[3]) | (ref[3] & got[3] & (far | (ref[2] != got[2])
                                                       | (ref[1] != got[1])))
    out["detections"] = int(apart.sum())
    return out


def leaf_gaps(port: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
              names: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over max(its reference norm, the median
    leaf's)."""
    pn = {k: float(torch.linalg.vector_norm(port[k].float())) for k in names}
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in names}
    med = statistics.median(rn.values())
    return {k: _finite(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)) for k in names}


def leaf_gap(port: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
             names: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap (:func:`leaf_gaps`) and its name."""
    gaps = leaf_gaps(port, ref, names)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _finite(x: float) -> float:
    """A gap that is not a number (a side went NaN) reads as infinite."""
    return x if math.isfinite(x) else math.inf


def train_numbers(port_losses: List[Dict[str, float]], port_grad: Mapping[str, torch.Tensor],
                  port_change: Mapping[str, torch.Tensor], ref_losses: List[Dict[str, float]],
                  ref_grad: Mapping[str, torch.Tensor], ref_change: Mapping[str, torch.Tensor],
                  backbone: str) -> Tuple[Dict[str, float], Dict[str, str]]:
    """The three train numbers and, for grad and change, the worst leaf."""
    gaps = [_finite(abs(p["loss"] - r["loss"]) / abs(r["loss"]))
            for p, r in zip(port_losses, ref_losses)]
    out = {"loss": max(gaps), "loss1": gaps[0]}
    names = [k for k in ref_grad if not runs_without_grad(k, backbone)]
    norms = {k: float(torch.linalg.vector_norm(ref_grad[k])) for k in names}
    med = statistics.median(norms.values())
    names = [k for k in names if norms[k] >= SMALL_LEAF * med]
    trained = [k for k in names if not is_frozen(k, backbone)]
    out["grad"], g_leaf = leaf_gap(port_grad, ref_grad, trained)
    out["grad_frozen"], f_leaf = leaf_gap(port_grad, ref_grad, names)
    out["change"], c_leaf = leaf_gap(port_change, ref_change, trained)
    out["grad_median"] = statistics.median(leaf_gaps(port_grad, ref_grad, trained).values())
    out["change_median"] = statistics.median(leaf_gaps(port_change, ref_change,
                                                        trained).values())
    return out, {"grad": g_leaf, "grad_frozen": f_leaf, "change": c_leaf}


def port_first_gradient(momentum: Mapping[str, torch.Tensor], p0: Mapping[str, torch.Tensor],
                        ocfg) -> Dict[str, torch.Tensor]:
    return {k: first_gradient(v.float(), p0[k].float(), ocfg) for k, v in momentum.items()}


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]], Dict[str, float]]:
    """correct when every number the limits name was read and is at most
    its limit, and no number the limits do not know (a check that did not
    run) came; returns (correct, the compared numbers beside their limits,
    the numbers read but not compared)."""
    rows = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    other = {k: v for k, v in numbers.items() if k not in limits}
    ok = all(r["value"] is not None and r["value"] <= r["limit"] for r in rows.values())
    return ok and not other.keys() - READ_ONLY, rows, other


def load_limits(path) -> Dict[str, float]:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}

